"""The port's own copy of the configuration vs the JAX package's, and the
port's default device.

gpismap_tpu_torch/config.py is a copy, not a load, of
gpismap_tpu/config.py (the port imports nothing of the JAX package):
every dataclass, default and calibration table must equal the original
field by field.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu import config as jcfg  # noqa: E402
from gpismap_tpu_torch import GPisMap2D, GPisMap3D  # noqa: E402
from gpismap_tpu_torch import config as tcfg  # noqa: E402

CLASSES = ("TreeParam", "ObsGPParam", "MapperParam", "CameraParam",
           "CapacityParam")
DEFAULTS = ("TREE_2D", "TREE_3D", "OBSGP_1D", "OBSGP_2D", "MAPPER_2D",
            "MAPPER_3D", "CAPACITY_2D", "CAPACITY_3D")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match_jax(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert jc is not tc and tc.__module__ == "gpismap_tpu_torch.config"
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tc)]
    assert tf == jf
    assert tc.__dataclass_params__.frozen and jc.__dataclass_params__.frozen


@pytest.mark.parametrize("name", DEFAULTS)
def test_default_instances_match_jax(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert type(t).__name__ == type(j).__name__
    assert _fields(t) == _fields(j)
    # derived properties too
    for prop in ("min_halfleng_sqr", "three_over_scale"):
        if hasattr(j, prop):
            assert getattr(t, prop) == getattr(j, prop)


@pytest.mark.parametrize("name", ["BIGBIRD_CAMS", "YCB_CAMS"])
def test_camera_tables_match_jax(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [_fields(c) for c in t] == [_fields(c) for c in j]


@pytest.mark.parametrize("cls", [GPisMap2D, GPisMap3D])
def test_default_device_is_cuda(cls):
    """Both mappers default to the card, with no fallback to the CPU:
    without one the default construction raises, and device="cpu"
    builds a CPU mapper."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks machines "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls()
    assert cls(device="cpu").device == torch.device("cpu")
