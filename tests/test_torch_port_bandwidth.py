"""The copy probe of ``srgan_tpu_torch.tools.norm_bandwidth_bench`` on the
CPU: its plain version copies exactly in both launch layouts, the
wrapper refuses what the kernel does not take, and the measurement
refuses to run anywhere but on a CUDA card. (The kernel itself is held
to the plain version on the card: ``tests/test_torch_port_cuda.py``.)"""

import pytest
import torch

from srgan_tpu_torch.tools import norm_bandwidth_bench as bandwidth


@pytest.mark.parametrize("layout,rows", [("per_example", 0),
                                         ("batch_strided", 64),
                                         ("batch_strided", 576)])
def test_plain_copy_is_exact_in_both_layouts(layout, rows):
    x = torch.randn((3, 192, 64), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    before = bandwidth.copy.launches
    got = bandwidth.copy(x, layout, rows)
    assert bandwidth.copy.launches == before  # a CPU tensor: no kernel
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)


def test_the_rows_must_divide_the_flat_view():
    x = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divide"):
        bandwidth.copy(x, "batch_strided", 5)
    with pytest.raises(ValueError, match="layout"):
        bandwidth.copy(x, "diagonal")


def test_the_rows_of_the_jax_tool_divide_both_shapes():
    for b, hw, _ in bandwidth.SHAPES:
        assert all((b * hw) % rows == 0 for rows in bandwidth.ROWS)


def test_measuring_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA card"):
        bandwidth.run(shapes=[(2, 8, 64)], device=torch.device("cpu"))


@pytest.mark.parametrize("layout,rows", [("per_example", 0),
                                         ("batch_strided", 64)])
def test_plain_copy_writes_into_a_given_output(layout, rows):
    """The tool times every variant into one reused output."""
    x = torch.randn((3, 192, 64), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    out = torch.full_like(x, float("nan"))
    got = bandwidth.copy(x, layout, rows, out)
    assert got.data_ptr() == out.data_ptr() and torch.equal(out, x)
    for bad in (torch.empty((3, 192, 32), dtype=torch.bfloat16),
                torch.empty_like(x, dtype=torch.float32),
                torch.empty((3, 64, 192), dtype=torch.bfloat16).mT):
        with pytest.raises(ValueError, match="out must be"):
            bandwidth.copy(x, layout, rows, bad)

