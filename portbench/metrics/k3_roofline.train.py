"""k3_roofline.train: the kernel's least time at the cell's shapes
(``portbench.yardstick``) over its measured time, in percent; the kernel
called directly after the window on the window's last inputs
(``portbench.kernels``)."""


def read(run):
    probe = run.kernels.get("k3")
    return None if probe is None else probe()
