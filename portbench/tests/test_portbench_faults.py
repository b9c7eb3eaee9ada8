"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (CPU, tiny size) and the rest of a run
is driven with each fault the cell can have planted in the program. A
one-card cell has no exchange between chips to leave out."""

import torch

import tiny
from shwd_torch.data.transforms import RegistrationBatch
from shwd_torch.losses.shwd import SHWDLoss
from shwd_torch.train import flow_driver
from shwd_torch.train.trainer import Trainer


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def test_training_with_its_state_left_unchanged(monkeypatch):
    tiny.kernel_route(monkeypatch)
    _state_unchanged(monkeypatch)
    run = tiny.train_run(seed=5)
    assert tiny.values(run)["change_gap"] > 0.99
    assert not tiny.correct(run)


def _phi_adam(monkeypatch, **changes):
    """phi's Adam built by the program with ``changes`` to its settings."""
    from shwd_torch.utils.optim import torch_adam

    def new_opt(self, phi):
        c = self.cfg
        kw = {"lr": c.phi_lr, "weight_decay": c.phi_weight_decay, "b1": c.phi_b1,
              "b2": c.phi_b2, **changes}
        return torch_adam(phi.parameters(), kw.pop("lr"), kw.pop("weight_decay"), **kw)

    monkeypatch.setattr(SHWDLoss, "_new_opt", new_opt)


def test_training_with_a_wrong_phi_update(monkeypatch):
    # phi's Adam takes b1 from the max_ssw block (0.5) in place of its own
    # (0.9): the losses and PCRNet's leaves barely move, phi's change does
    tiny.kernel_route(monkeypatch)
    _phi_adam(monkeypatch, b1=0.5)
    run = tiny.train_run(seed=5)
    assert tiny.values(run)["phi_change_gap"] > run.workload["limits"]["phi_change_gap"]
    assert not tiny.correct(run)


def test_training_with_phi_left_unchanged(monkeypatch):
    tiny.kernel_route(monkeypatch)
    _phi_adam(monkeypatch, lr=0.0)
    run = tiny.train_run(seed=5)
    assert tiny.values(run)["phi_change_gap"] > 0.99
    assert not tiny.correct(run)


def test_training_on_half_of_each_batch(monkeypatch):
    tiny.kernel_route(monkeypatch)
    whole = Trainer._train_step

    def half(self, state, batch):
        return whole(self, state, RegistrationBatch(*(t[:t.shape[0] // 2] for t in batch)))

    monkeypatch.setattr(Trainer, "_train_step", half)
    assert not tiny.correct(tiny.train_run(seed=5))


def test_flow_with_its_state_left_unchanged(monkeypatch):
    _state_unchanged(monkeypatch)
    run = tiny.flow_run(seed=5)
    assert tiny.values(run)["interval_w2_gap"] > 0.5
    assert not tiny.correct(run)


def test_flow_on_half_of_its_points(monkeypatch):
    whole = SHWDLoss.apply

    def half(self, state, x, y, train=True):
        n = x.shape[-2] // 2
        return whole(self, state, x[..., :n, :], y[..., :n, :], train)

    monkeypatch.setattr(SHWDLoss, "apply", half)
    assert not tiny.correct(tiny.flow_run(seed=5))


def test_flow_with_a_point_of_its_answer_moved(monkeypatch):
    whole = flow_driver.run_flow

    def moved(source, target, cfg, eval_fn=None, **kw):
        def altered(points, tgt):
            points = points.copy()
            points[0, 0] += 1.0
            return eval_fn(points, tgt)
        return whole(source, target, cfg, eval_fn=altered, **kw)

    monkeypatch.setattr(flow_driver, "run_flow", moved)
    assert not tiny.correct(tiny.flow_run(seed=5))
