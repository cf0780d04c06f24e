"""The frozen reference against the port's plain path at a tiny size, on
seeded weights: a sampled image and three train iterations (R1 on the
first) of both configurations' shapes, in float32 on the CPU."""

import pytest
import torch

from portbench.drivers import sample, train
from portbench.reference import trainer as ref_trainer
from portbench.tests import tiny

# float32 on both sides, the same draws: only the order of the sums differs
TOL = 1e-4


@pytest.mark.parametrize("config", [tiny.QS, tiny.T2I], ids=["qs", "t2i"])
def test_sample_matches_port(config, tmp_path):
    numbers = sample.readings(tiny.context(tiny.sample_cell(config),
                                           tmp_path))
    assert numbers["image_gap"][0] < TOL
    assert numbers["pixel_gap"][0] < TOL


@pytest.mark.parametrize("config", [tiny.QS, tiny.T2I], ids=["qs", "t2i"])
def test_train_matches_port(config, tmp_path):
    numbers = train.readings(tiny.context(tiny.train_cell(config), tmp_path))
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert numbers[name][0] < TOL, (name, numbers)


def test_weights_are_drawn_from_the_seed():
    a = ref_trainer.make_weights(tiny.T2I, 5, "cpu")
    b = ref_trainer.make_weights(tiny.T2I, 5, "cpu")
    c = ref_trainer.make_weights(tiny.T2I, 6, "cpu")
    for key in ("G", "D", "VD", "clip"):
        sa, sb, sc = (m[key].state_dict() for m in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert any(not torch.equal(sa[k], sc[k]) for k in sa
                   if sa[k].std() > 0)


def test_reference_weights_load_into_the_port(tmp_path):
    from portbench import program

    ctx = tiny.context(tiny.train_cell(tiny.T2I), tmp_path)
    gan = program.build(tiny.T2I, seed=1, device="cpu", out=tmp_path)
    models = ref_trainer.make_weights(tiny.T2I, 3, "cpu")
    program.load_weights(gan, models)
    for key, mod in (("G", gan.G), ("D", gan.D), ("VD", gan.VD),
                     ("clip", gan.clip.model)):
        want = models[key].state_dict()
        got = mod.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert ctx.cell.traffic["driver"] == "train"


def test_control_rounds_the_backward_products_too():
    """Under the fp8 control a product's gradients come from fp8 operands:
    the weight's gradient moves beyond what rounding the forward operands
    alone gives, and the R1-style double backward still runs."""
    from portbench.reference import numerics as nm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 8, 8, generator=gen, requires_grad=True)
    w = torch.randn(5, 3, 3, 3, generator=gen, requires_grad=True)

    def grads(fp8, backward=True):
        with nm.numerics(fp8=fp8):
            if backward:
                y = nm.conv2d(x, w, padding=1)
            else:  # the forward operands' rounding alone
                y = torch.nn.functional.conv2d(nm.q(x), nm.q(w), padding=1)
            gx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
            gw, = torch.autograd.grad(gx.square().sum(), w)
        return gw

    exact, forward_only, control = grads(False), grads(True, False), \
        grads(True)
    assert torch.isfinite(control).all()
    assert not torch.equal(control, forward_only)
    assert (control - exact).norm() > (forward_only - exact).norm()
