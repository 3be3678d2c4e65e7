"""The port's sphere_trace against gpismap_tpu.render.sphere_trace on the
synthetic floor-plan map that chip_smoke.py renders, on the CPU.

The map is built once by the port from the 28 full 1081-beam frames of
tests/torch_scenes.py and carried into the JAX package with
runtime/checkpoint; every 16th of the 30,268 beams is marched by both at
the JAX package's default of 48 steps and at the 96 that chip_smoke.py's
2D render gate holds. Both must give the same hits, steps, t and march
depth. Each case prints what the smoke's gates read on the full beam set:
the hit share of the beams with a true range, the share that hit within
0.5 m of it, and the median |t - range| at hits. About a fifth of the
hits stop short of the wall at zero crossings of the posterior mean in
cells far from data (near-prior variance); the JAX hit rule stops there
too, so the share within 0.5 m is the reference's and the smoke's floor
sits below it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu_torch import GPisMap2D, render  # noqa: E402
from gpismap_tpu_torch.runtime import checkpoint  # noqa: E402

# port vs JAX on the same f32 map: rounding order only
TOL = dict(rtol=1e-4, atol=1e-4)
# the march depth of a ray that never hits sums up to n_steps steps of f,
# each rounded in its own order
MARCH_TOL = dict(rtol=1e-3, atol=1e-4)
EVERY = 16


@pytest.fixture(scope="module")
def floor(tmp_path_factory):
    """The port's 2D map of the floor plan, its checkpoint, and every
    EVERY-th beam with its noise-free range."""
    m = GPisMap2D(device="cpu")
    m.update_batch(torch_scenes.floor_frames(28))
    path = str(tmp_path_factory.mktemp("floor") / "floor.npz")
    checkpoint.save(m, path)
    o, d, rng = torch_scenes.beams(torch_scenes.floor_plan(),
                                   torch_scenes.floor_trajectory(28))
    return dict(map=m, path=path, o=o[::EVERY], d=d[::EVERY],
                rng=rng[::EVERY])


def _stats(hit, t, rng):
    fin = rng < torch_scenes.MAX_RANGE
    err = np.abs(t - rng)
    return (float((hit & fin).sum() / fin.sum()),
            float((hit & fin & (err < 0.5)).sum() / fin.sum()),
            float(np.median(err[hit & fin])),
            int((hit & ~fin).sum()))


@pytest.mark.parametrize("n_steps", [48, 96])
def test_floor_render_matches_jax(floor, n_steps):
    import jax.numpy as jnp
    from gpismap_tpu import render as jrender
    from gpismap_tpu.api import GPisMap2D as JaxMapper
    from gpismap_tpu.runtime import checkpoint as jckpt

    m = floor["map"]
    cfg = render.config_from_mapper(m, n_steps=n_steps)
    out = render.sphere_trace(m.store, m.grid, torch.as_tensor(floor["o"]),
                              torch.as_tensor(floor["d"]), cfg,
                              m._get_factors())
    out = {k: v.detach().numpy() for k, v in out.items()}
    mj = JaxMapper()
    jckpt.load(mj, floor["path"])
    assert mj.num_nodes == m.num_nodes
    ref = jrender.sphere_trace(mj.store, mj.grid, jnp.asarray(floor["o"]),
                               jnp.asarray(floor["d"]),
                               jrender.config_from_mapper(mj,
                                                          n_steps=n_steps),
                               mj._get_factors())
    ref = {k: np.asarray(v) for k, v in ref.items()}

    np.testing.assert_array_equal(out["hit"], ref["hit"])
    np.testing.assert_array_equal(out["steps"], ref["steps"])
    np.testing.assert_allclose(out["t_hat"], ref["t_hat"], **MARCH_TOL)
    hit = out["hit"]
    for k in ("t", "pos", "normal", "var"):
        np.testing.assert_allclose(out[k][hit], ref[k][hit], err_msg=k,
                                   **TOL)
    share, good, med, false = _stats(hit, out["t"], floor["rng"])
    print(f"\n{len(hit)} beams, {n_steps} steps: port and JAX hit "
          f"{share:.4f} of the beams with a true range, {good:.4f} within "
          f"0.5 m of it; median |t - range| at hits {med:.4g} m; hits "
          f"without a true range {false}; rays out of steps "
          f"{int(((~hit) & (out['steps'] == n_steps)).sum())}")
    assert share > 0.5 and med < 0.05
