"""The benchmark's own byte and operation counts."""
import pytest

from cost import peaks, stencils

CELLS_256 = 256 ** 3


def test_field_passes():
    assert [k.fields for k in stencils.KERNELS] == [6, 4, 3, 7]
    assert stencils.step_field_passes(40) == 137
    assert stencils.step_bytes(CELLS_256, 40) == 137 * CELLS_256 * 4


@pytest.mark.parametrize("kernel, ms", [
    (stencils.JACOBI_PRESSURE, 0.0601), (stencils.UPDATE_VELOCITY, 0.1202),
    (stencils.DIVERGENCE, 0.0801), (stencils.PROJECT_VELOCITY, 0.1402)])
def test_bounds_at_256(kernel, ms):
    assert round(kernel.least_s(CELLS_256) * 1e3, 4) == ms


def test_the_kernel_table_counted_padded_inputs_where_a_kernel_takes_them():
    """The port's kernel table gives DIVERGENCE 0.0808 and PROJECT_VELOCITY
    0.1405 ms at 256^3: their inputs as padded (257 wide on one side),
    where the benchmark counts each field unpadded."""
    padded = 257 ** 3
    hbm = peaks.PEAKS["h100-sxm"]["hbm_bytes_per_s"]
    assert round((3 * padded + CELLS_256) * 4 / hbm * 1e3, 4) == 0.0808
    assert round((6 * CELLS_256 + padded) * 4 / hbm * 1e3, 4) == 0.1405


def test_every_stencil_and_the_step_are_bound_by_bytes():
    for k in stencils.KERNELS:
        assert k.bytes(CELLS_256) / 3.35e12 > k.flops(CELLS_256) / 67e12
    assert stencils.step_flops(1, 40) == 144 + 6 + 40 * 11 + 10
    assert stencils.step_least_s(512 ** 3, 40) == pytest.approx(
        137 * 4 * 512 ** 3 / 3.35e12)
