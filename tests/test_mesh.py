"""map_mesh: device-count checks fail with a clear error."""

import jax
import pytest

from vloam_tpu.parallel.mesh import map_mesh


def test_map_mesh_spans_requested_devices():
    mesh = map_mesh(4)
    assert mesh.devices.shape == (4,) and mesh.axis_names == ("map",)


@pytest.mark.parametrize("n", [0, 1000])
def test_map_mesh_bad_count_raises(n):
    with pytest.raises(RuntimeError, match=f"map_mesh\\({n}\\)"):
        map_mesh(n)
    assert len(jax.devices()) >= 1
