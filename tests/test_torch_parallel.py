"""The port's mesh (gpismap_tpu_torch.parallel) on the CPU: a size-1 mesh
in this process, and one run of two gloo ranks in two processes (the
multi-controller form the port runs on GPUs, one process per card).

The two ranks run the 2D room mapper with a mesh against the same mapper
without one (equal num_nodes, fields rtol 1e-4 / atol 5e-4, the
tolerances of tests/test_parallel.py:90-95: the mesh's retrain keeps no
Cholesky factor, so its cache refresh re-factorizes), sharded_map_test
against map_test (1e-5, tests/test_parallel.py:66-69), the replicas'
digests through check_replicas(), a hypergradient all-reduced over the
ranks against one rank's (tests/test_hypergrad.py:108) and a ray-sharded
sphere_trace against one rank's (tests/test_parallel.py:175); then a
small 3D run (the 64x48 camera, two frames). The workers import torch
and the port only. Rank 0 writes its results to an .npz that this
process holds against the JAX package's GPisMap2D(mesh=...) and
GPisMap3D(mesh=...) on its 8-device CPU mesh over the same frames, at
1e-4 (normals 1e-3).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu_torch import (CameraParam, CapacityParam, GPisMap2D,  # noqa: E402,E501
                               GPisMap3D)
from gpismap_tpu_torch.parallel import data_mesh  # noqa: E402
from test_torch_slice import TINY as TINY_2D  # noqa: E402
from test_torch_slice import TOL  # noqa: E402
from test_torch_slice import _queries as _queries_2d  # noqa: E402
from test_torch_slice3d import CAM, GRAD_TOL, _check_field  # noqa: E402
from test_torch_slice3d import TINY as TINY_3D  # noqa: E402
from test_torch_slice3d import _queries as _queries_3d  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

_WORKER = r'''
import json, sys, traceback
import numpy as np
import torch
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
args = json.load(open(sys.argv[4]))
sys.path.insert(0, args["tests"])
import torch_scenes
from gpismap_tpu_torch import (CameraParam, CapacityParam, GPisMap2D,
                               GPisMap3D, TREE_2D, render)
from gpismap_tpu_torch.models import cluster
from gpismap_tpu_torch.parallel import multihost, sharded_map_test
from gpismap_tpu_torch.runtime.index import SpatialIndex

multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
mesh = multihost.global_data_mesh(device="cpu")
assert (mesh.size, mesh.rank) == (2, rank), mesh
assert mesh.comm_device.type == "cpu"
inp = np.load(args["inputs"])
res = {}
tol = dict(rtol=1e-4, atol=5e-4)


def run_2d():
    cap = CapacityParam(**args["tiny_2d"])
    m1 = GPisMap2D(cap=cap, device="cpu")
    mm = GPisMap2D(cap=cap, mesh=mesh)
    q = inp["q2"]
    frames = torch_scenes.room_frames(3, 181)
    for i, f in enumerate(frames + frames[-1:]):
        m1.update(*f)
        mm.update(*f)
        if i >= len(frames) - 1:     # a warm cache for the last retrain
            r1, rm = m1.test(q), mm.test(q)
    res["digest_2d"] = mm.check_replicas()
    assert mm.num_nodes == m1.num_nodes > 0
    np.testing.assert_allclose(rm, r1, **tol)
    res["test_2d"] = rm
    d = mm.index.dump_nodes()
    res["alive_2d"], res["pos_2d"], res["grad_2d"] = (
        d["alive"], d["pos"], d["grad"])
    kw = mm._test_kwargs()
    qt = torch.as_tensor(q)
    one = cluster.map_test(mm.store, mm.grid, qt,
                           factors=mm._get_factors(), **kw)
    shd = sharded_map_test(mm.store, mm.grid, qt, mesh,
                           factors=mm._get_factors(), **kw)
    for a, b in zip(one[:4], shd[:4]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    res["sharded_bitwise"] = all(torch.equal(a, b)
                                 for a, b in zip(one[:4], shd[:4]))
    # the multi-process helpers: rank 0's store and grid on every rank,
    # a global batch from each rank's rows, and back
    store, grid = multihost.replicate(mesh, (mm.store, mm.grid))
    assert all(torch.equal(a, b) for a, b in zip(store, mm.store))
    assert torch.equal(grid, mm.grid)
    mine = q[rank * len(q) // 2:(rank + 1) * len(q) // 2]
    whole = multihost.global_query_array(mesh, mine)
    np.testing.assert_array_equal(whole.numpy(), q)
    np.testing.assert_array_equal(multihost.local_rows(mesh, whole), mine)
    n_pairs = int(shd[4].n_pairs)
    assert n_pairs == int(one[4].n_pairs) > 0, (n_pairs, one[4])


def circle_map():
    """The unit-circle map of tests/test_parallel.py:_circle_map."""
    cap = CapacityParam(gp_support=16, retrain_batch=8, max_cells=64,
                        max_nodes=512, test_tile=16, test_active_cells=16,
                        max_beams=64)
    idx = SpatialIndex(2, TREE_2D, max_slots=cap.max_cells)
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ids = idx.try_insert(pts)
    ok = ids >= 0
    nrm = pts[ok] / np.linalg.norm(pts[ok], axis=1, keepdims=True)
    idx.set_node_data(ids[ok], np.full(ok.sum(), -0.2, np.float32),
                      np.full(ok.sum(), 0.02, np.float32), nrm,
                      np.full(ok.sum(), 0.02, np.float32))
    rt = idx.collect_retrain(4.0, cap.gp_support, cap.max_cells)
    d = idx.dump_nodes()
    sup = rt["support"]
    supc = np.clip(sup, 0, None)
    data = [torch.as_tensor(a) for a in (
        rt["slots"], rt["slots"] >= 0, d["pos"][supc], d["grad"][supc],
        d["val"][supc], d["pos_sig"][supc], d["grad_sig"][supc], sup >= 0)]
    centers, _, slots = idx.cell_info(idx.all_cluster_cells())
    grid = cluster.build_grid(np.floor(centers / 1.6).astype(np.int64),
                              slots, 2, 128, torch.device("cpu"))
    cfg = render.RenderConfig(
        cell_size=1.6, grid_half=128, noff=4, search_half=4.8, scale=1.2,
        val_const=1.01, grad_const=3.0 / 1.44 + 0.1, var_thre=0.4,
        default_var=1.01, tile=cap.test_tile, max_cells=cap.max_cells,
        max_active=cap.test_active_cells, fbias=0.2, n_steps=24, t_max=6.0)
    return cap, data, grid, cfg


def run_render():
    cap, data, grid, cfg = circle_map()

    def loss(s, q):
        store = cluster.retrain_cells(
            cluster.make_store(cap, 2, torch.device("cpu")), *data[:8], s)
        f, _, vf = render.sdf_eval(store, grid, q, cfg,
                                   hyper=render.hyper_from_scale(s, 2))
        return torch.sum(f) + torch.sum(vf)

    q = torch.as_tensor(inp["q_hyper"])
    s = torch.tensor(1.2, requires_grad=True)
    (g1,) = torch.autograd.grad(loss(s, q), s)
    (gl,) = torch.autograd.grad(loss(s, mesh.shard(q)), s)
    gm = mesh.all_reduce_sum(gl)
    np.testing.assert_allclose(float(gm), float(g1), rtol=1e-4, atol=1e-5)
    res["hypergrad"] = np.array([float(g1), float(gm)])

    store = cluster.retrain_cells(
        cluster.make_store(cap, 2, torch.device("cpu")), *data[:8], 1.2)
    o, dr = (torch.as_tensor(inp[k]) for k in ("ray_o", "ray_d"))
    r1 = render.sphere_trace(store, grid, o, dr, cfg)
    rl = render.sphere_trace(store, grid, mesh.shard(o), mesh.shard(dr),
                             cfg)
    for key in ("t", "hit", "normal"):
        full = mesh.all_gather(rl[key])
        if key == "hit":
            assert torch.equal(full, r1[key])
        else:
            np.testing.assert_allclose(full.numpy(), r1[key].numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert float(r1["hit"].float().mean()) > 0.9


def run_3d():
    cap = CapacityParam(**args["tiny_3d"])
    cam = CameraParam(**args["cam"])
    m1 = GPisMap3D(cap=cap, camera=cam, device="cpu")
    mm = GPisMap3D(cap=cap, camera=cam, mesh=mesh)
    frames = torch_scenes.object_frames(2, cam)
    q = inp["q3"]
    for i, f in enumerate(frames + frames[-1:]):
        m1.update(*f)
        mm.update(*f)
        if i >= len(frames) - 1:
            r1, rm = m1.test(q), mm.test(q)
    res["digest_3d"] = mm.check_replicas()
    assert mm.num_nodes == m1.num_nodes > 100
    np.testing.assert_allclose(rm, r1, **tol)
    res["test_3d"] = rm
    d = mm.index.dump_nodes()
    res["alive_3d"], res["pos_3d"], res["grad_3d"] = (
        d["alive"], d["pos"], d["grad"])


for name, fn in (("2d", run_2d), ("render", run_render), ("3d", run_3d)):
    try:
        fn()
        print(f"PART_OK {name} rank={rank}", flush=True)
    except Exception:
        traceback.print_exc()
        print(f"PART_FAILED {name} rank={rank}", flush=True)
        sys.stdout.flush()
        import os
        os._exit(1)
if rank == 0:
    np.savez(out, **res)
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the worker on two gloo ranks once; (outputs, rank 0's npz)."""
    tmp = tmp_path_factory.mktemp("mesh")
    worker = tmp / "mesh_worker.py"
    worker.write_text(_WORKER)
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    o = (3.0 * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.float32)
    np.savez(tmp / "inputs.npz", q2=_queries_2d(), q3=_queries_3d(384),
             q_hyper=rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32),
             ray_o=o, ray_d=(-o / 3.0).astype(np.float32))
    (tmp / "args.json").write_text(json.dumps(dict(
        tests=TESTS, inputs=str(tmp / "inputs.npz"), tiny_2d=TINY_2D,
        tiny_3d=TINY_3D, cam=CAM)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), port, str(tmp / "out.npz"),
         str(tmp / "args.json")], cwd=str(tmp), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    res = dict(np.load(tmp / "out.npz")) if (tmp / "out.npz").exists() \
        else None
    return outs, res


def _part_ok(outs, part):
    for r, out in enumerate(outs):
        assert f"PART_OK {part} rank={r}" in out, out[-4000:]


def test_size1_mesh_equals_unsharded(monkeypatch):
    """A size-1 mesh in this process (no process group) runs the mesh
    path: the same store and field as the mapper without a mesh to the
    last bit, and, after the last frame ingested again with a warm
    cache, the same cache as the mirror-off mapper, whose retrain keeps
    no factor either."""
    mesh = data_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    cap = CapacityParam(**TINY_2D)
    plain = GPisMap2D(cap=cap, device="cpu")
    meshed = GPisMap2D(cap=cap, mesh=mesh)
    q = _queries_2d()
    frames = torch_scenes.room_frames(3, 181)
    for f in frames:
        plain.update(*f)
        meshed.update(*f)
    assert meshed.device == mesh.device
    assert plain.state_digest() == meshed.check_replicas()
    np.testing.assert_array_equal(meshed.test(q), plain.test(q))
    monkeypatch.setenv("GPISMAP_NODE_MIRROR", "0")
    off = GPisMap2D(cap=cap, device="cpu")
    for f in frames:
        off.update(*f)
    off.test(q)
    off.update(*frames[-1])
    r_off = off.test(q)
    monkeypatch.delenv("GPISMAP_NODE_MIRROR")
    meshed.update(*frames[-1])
    assert meshed._factors is not None
    np.testing.assert_array_equal(meshed.test(q), r_off)
    assert torch.equal(meshed._factors[0], off._factors[0])


def test_multihost_helpers_single_process():
    """multihost.initialize is a no-op in one process; the helpers work
    on the size-1 mesh that global_data_mesh then gives
    (tests/test_parallel.py::test_multihost_helpers)."""
    from gpismap_tpu_torch.parallel import multihost

    multihost.initialize()
    multihost.initialize("127.0.0.1:1", num_processes=1, process_id=0)
    mesh = multihost.global_data_mesh(device="cpu")
    assert (mesh.size, mesh.group) == (1, None)
    local = np.arange(64, dtype=np.float32).reshape(32, 2)
    arr = multihost.global_query_array(mesh, local)
    np.testing.assert_array_equal(arr.numpy(), local)
    np.testing.assert_array_equal(multihost.local_rows(mesh, arr), local)
    tree = (torch.ones(3), np.zeros((2, 2), np.int32))
    rep = multihost.replicate(mesh, tree)
    assert torch.equal(rep[0], tree[0]) and rep[1].dtype == torch.int32


def test_init_mesh_rejects_sizes():
    """The mesh size must be a power of two dividing 64 and
    retrain_batch (api.py:75-79 of the JAX package); the mapper's device
    is the mesh's, by default the card."""
    from gpismap_tpu_torch.parallel import Mesh

    for size in (3, 128):
        mesh = Mesh(None, 0, size, torch.device("cpu"), torch.device("cpu"))
        with pytest.raises(ValueError, match="power of two dividing 64"):
            GPisMap2D(cap=CapacityParam(**TINY_2D), mesh=mesh)
    mesh = Mesh(None, 0, 16, torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError, match="retrain_batch=8"):
        GPisMap3D(cap=CapacityParam(**TINY_3D), mesh=mesh)
    with pytest.raises(ValueError, match="not the mesh's"):
        GPisMap2D(cap=CapacityParam(**TINY_2D), device="cuda",
                  mesh=data_mesh(device="cpu"))
    # the mesh's default device is the card, never the CPU unasked
    assert data_mesh().device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GPisMap2D(cap=CapacityParam(**TINY_2D), mesh=data_mesh())


def test_two_rank_mapper_2d(two_ranks):
    """The 2D room on two gloo ranks (the worker's checks: the mapper
    without a mesh, sharded_map_test, the digests, the all-reduced
    hypergradient, the ray-sharded march) and rank 0's map against the
    JAX package's GPisMap2D on its 8-device CPU mesh."""
    import jax

    from gpismap_tpu.api import GPisMap2D as JaxMapper
    from gpismap_tpu.config import CapacityParam as JaxCapacity
    from gpismap_tpu.parallel import data_mesh as jax_mesh

    outs, res = two_ranks
    _part_ok(outs, "2d")
    _part_ok(outs, "render")
    assert res is not None
    mj = JaxMapper(cap=JaxCapacity(**TINY_2D),
                   mesh=jax_mesh(jax.devices()[:8]))
    frames = torch_scenes.room_frames(3, 181)
    for f in frames + frames[-1:]:
        mj.update(*f)
    mj.test(_queries_2d())
    dj = mj.index.dump_nodes()
    np.testing.assert_array_equal(res["alive_2d"], dj["alive"])
    alive = dj["alive"]
    np.testing.assert_allclose(res["pos_2d"][alive], dj["pos"][alive],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["grad_2d"][alive], dj["grad"][alive],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res["test_2d"], mj.test(_queries_2d()),
                               **TOL)
    print(f"sharded_map_test bitwise equal to map_test: "
          f"{bool(res['sharded_bitwise'])}; hypergradient one rank / two "
          f"ranks {res['hypergrad']}")


def test_two_rank_mapper_3d(two_ranks):
    """GPisMap3D(mesh=...) on the two gloo ranks, two frames and the
    second again: equal digests on both ranks, each rank's field against
    the same mapper without a mesh (the worker's checks), and rank 0's
    nodes and field against the JAX package's GPisMap3D on its 8-device
    CPU mesh (its split retrain and its bucketed refresh at n < M)."""
    import jax

    from gpismap_tpu.api3d import GPisMap3D as JaxMapper
    from gpismap_tpu.config import CameraParam as JaxCamera
    from gpismap_tpu.config import CapacityParam as JaxCapacity
    from gpismap_tpu.parallel import data_mesh as jax_mesh

    outs, res = two_ranks
    _part_ok(outs, "3d")
    assert str(res["digest_3d"]) != str(res["digest_2d"])
    mj = JaxMapper(cap=JaxCapacity(**TINY_3D), camera=JaxCamera(**CAM),
                   mesh=jax_mesh(jax.devices()[:8]))
    frames = torch_scenes.object_frames(2, CameraParam(**CAM))
    for f in frames + frames[-1:]:
        mj.update(*f)
    dj = mj.index.dump_nodes()
    np.testing.assert_array_equal(res["alive_3d"], dj["alive"])
    alive = dj["alive"]
    assert alive.sum() > 100
    np.testing.assert_allclose(res["pos_3d"][alive], dj["pos"][alive],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["grad_3d"][alive], dj["grad"][alive],
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    _check_field(res["test_3d"], mj.test(_queries_3d(384)))
