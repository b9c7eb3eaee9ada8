"""k2_roofline.flow: the kernel's least time at the cell's shapes
(``portbench.yardstick``) over its measured time, in percent; the kernel
called directly after the window on the window's last inputs
(``portbench.kernels``)."""


def read(run):
    probe = run.kernels.get("k2")
    return None if probe is None else probe()
