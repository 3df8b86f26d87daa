"""The control: the reference computed one precision below the
configuration's (fp8 in the products for the bfloat16 flagship), put in
the program's place, fails the cell's limits at a tiny size on the CPU,
where the program computes in float32. At the flagship's own size no
number separates it from the program's sound runs (PERF.md §2), so no
test holds it there. Beside it, the control's rounding itself."""

import pytest
import torch

from benchmark import study
from benchmark.harness import check
from benchmark.reference.quant import quantizer
from benchmark.tests.conftest import CELLS, tiny_cell


def test_fp8_rounds_the_operands_forward_and_the_gradient_backward():
    q = quantizer("fp8")
    x = torch.linspace(-3.0, 3.0, 101, requires_grad=True)
    y = q(x)
    # e4m3 keeps 3 bits of mantissa: 1.0625 lies between 1 and 1.125.
    assert not torch.equal(y, x) and (y - x).abs().max() <= 3.0 / 16
    (grad,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(grad, torch.ones_like(x))  # straight through
    w = torch.tensor([1.0, 1.0], requires_grad=True)
    (g,) = torch.autograd.grad(q.out(w * 1.0), w, torch.tensor([4.0, 1.0625]))
    # e5m2 keeps 2 bits of mantissa: under the scale of 4, 1.0625
    # comes back as 1.
    assert g.tolist() == [4.0, 1.0]
    # The double backward runs through the rounding as the identity:
    # d/dw of the gradient of Σ w³, with exact values, is 6w.
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad((q.out(w * w) * w).sum(), w,
                               create_graph=True)
    assert g.tolist() == [3.0, 12.0]
    (gg,) = torch.autograd.grad(g.sum(), w)
    assert gg.tolist() == [6.0, 12.0]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_a_tiny_size(name):
    cell = tiny_cell(name)
    numbers = study.readings(cell, "control", 2 ** 31 + 5,
                             torch.device("cpu"))
    assert not check.verdict(numbers, cell.workload["limits"]), numbers
