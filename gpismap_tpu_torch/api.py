"""User-facing 2D online GPIS mapper on PyTorch, and the host
orchestration both mappers share.

Port of gpismap_tpu/api.py:GPisMap2D (snapshot and strict re-evaluation)
and of the dimension-free parts of its _MeshMixin and _retrain_store.
A host orchestrator that drives:
  * the native spatial index (csrc/gpis_index.cpp) for tree mutations
  * the per-frame tensor stages (models/mapper2d.py) for the GP math
  * the cluster-GP store, the node mirror and the factor cache
    (models/cluster.py) for the retrain and test()
on one torch device, or on every rank of a parallel.mesh.Mesh (mesh=):
each rank keeps a replica of the whole map, computes its share of the
batches whose rows are independent, and all-gathers the results, so
every rank replays the same host index (_MapperBase).

GPISMAP_NODE_MIRROR=0 (read at each retrain) gathers the retrain's
support on the host instead of from the device node mirror, as the JAX
package does; that retrain, like a mesh's, keeps no Cholesky factor, so
the factor cache is refreshed by re-factorizing the retrained cells
(cluster.update_factors), grouped into at most two refresh sizes
(_refresh_buckets).

With GPISMAP_NBR_TABLE=1, test() finds each query's candidate cells
through a precomputed candidate table (cluster.NeighborTable), as the
JAX package does by default on its accelerator; the results are the
window path's. Unset, the table is off on every device: on the H100 it
saves no query time and costs its build at the first test() after each
retrain (PERF.md).

With GPISMAP_PALLAS_BF16=1 (or on), read at each test(), a mapper on a
CUDA device runs the tile kernel's bf16 variant: the variance product
with bfloat16 multiplicands and f32 accumulation, f and grad unchanged
(ops/tile_eval.py). It is off by default, forward-only, and a mapper on
the CPU ignores it, as the JAX package does off its accelerator.
"""
from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from .config import (CAPACITY_2D, MAPPER_2D, OBSGP_1D, TREE_2D,
                     CapacityParam, MapperParam, ObsGPParam, TreeParam)
from .models import cluster, mapper2d
from .runtime import spans
from .runtime.index import SpatialIndex


def _next_pow2(n: int, lo: int = 64) -> int:
    return max(lo, 1 << max(0, (n - 1)).bit_length())


def _default_buckets(mcap: int) -> tuple:
    """Support-size buckets of the retrain (ascending, last == capacity)."""
    cand = sorted({max(16, mcap // 4), max(16, mcap // 2), mcap})
    return tuple(b for b in cand if b <= mcap)


def _pad_ids(node_ids: np.ndarray):
    """(node ids padded with -1 to a pow2 length k, valid mask [k])."""
    n = len(node_ids)
    k = _next_pow2(max(n, 1))
    sel = np.full(k, -1, np.int32)
    sel[:n] = node_ids
    valid = np.zeros(k, bool)
    valid[:n] = True
    return sel, valid


def _to_numpy(nt):
    """One host copy of every tensor of a NamedTuple."""
    return type(nt)(*(x.cpu().numpy() for x in nt))


class _MapperBase:
    """The dimension-free host orchestration of both mappers: device
    checks, the mesh, map reset, the new-measurement insert, the node
    mirror, the bucketed retrain, the cluster grid, the factor cache and
    test() (the JAX package's _MeshMixin and _retrain_store).

    A subclass sets params, the dimension and the test search box
    through _setup, and supplies update() and the test constants
    (_test_kwargs). The candidate table, when GPISMAP_NBR_TABLE turns
    it on, is built at the first test() after a change of the map and
    dropped by every retrain, reset and load.

    With a mesh (parallel.mesh.Mesh; the JAX package's _MeshMixin, on
    one process per GPU): test() splits its queries over the ranks
    (cluster.map_test_sharded); the retrain pads each chunk to at least
    the mesh size, every rank fits its rows and the fitted store rows
    are all-gathered into every rank's store; the subclasses split their
    per-frame batches of independent rows (_shard/_gather). No fit keeps
    its Cholesky factor (a rank holds only its rows'), so the factor
    cache refreshes through cluster.update_factors. Every other stage
    runs replicated, and every rank replays the same host index from
    the same gathered results: check_replicas() proves it."""

    def _setup(self, params: MapperParam, obs_param: ObsGPParam,
               tree: TreeParam, cap: CapacityParam, dim: int,
               device, search_half: float, mesh=None) -> None:
        self.cap = cap
        self._init_mesh(mesh)
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = torch.device(device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"{type(self).__name__}: device {self.device} "
                             f"is not the mesh's {mesh.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}(device="
                               f"'{self.device}'): no CUDA device is "
                               f"available; pass device='cpu' to run on "
                               f"the CPU")
        self.p = params
        self.op = obs_param
        self.tp = tree
        self.dim = dim
        self.index = SpatialIndex(dim, tree, max_slots=cap.max_cells)
        self.cell_size = 2.0 * tree.cluster_halfleng
        # the root can double once past max_halfleng (quadtree.cpp:162-165)
        self.grid_half = int(round(2.0 * tree.max_halfleng / self.cell_size))
        # test() search box half-width, and the grid window that covers it
        self._search_half = search_half
        self._noff = int((search_half + self.cell_size) / self.cell_size)
        self._retrain_buckets = _default_buckets(cap.gp_support)
        self.stats: dict = {}
        self.reset()

    def reset(self):
        """Drop all map state (mexGPisMap.cpp:123-130)."""
        self.index.reset()
        self.store = cluster.make_store(self.cap, self.dim, self.device)
        self.grid = cluster.build_grid(np.zeros((0, self.dim), np.int64),
                                       np.zeros(0, np.int32), self.dim,
                                       self.grid_half, self.device)
        self.frame = 0
        self._factors = None    # cached per-cell L^-1 (linv_buf, uniq)
        self._factors_slots = None  # the live slots the cache was filled for
        self._mirror = None     # device node mirror (cluster.NodeMirror)
        self._nbrs = None       # candidate table (cluster.NeighborTable)
        self._nbr_dense = False

    def _init_mesh(self, mesh) -> None:
        """Keep the mesh (None: one device). Padded batches are powers of
        two >= 64 and retrain chunks divide retrain_batch, so the size
        must be a power of two dividing both."""
        self.mesh = mesh
        if mesh is None:
            return
        if 64 % mesh.size != 0 or self.cap.retrain_batch % mesh.size != 0:
            raise ValueError(
                f"mesh size {mesh.size} must be a power of two dividing "
                f"64 and retrain_batch={self.cap.retrain_batch} "
                "(sharded axes are padded to multiples of these)")

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch (all of it without a mesh)."""
        return x if self.mesh is None else self.mesh.shard(x)

    def _gather(self, nt):
        """Every rank's rows of a NamedTuple of row batches, in one
        collective (nt itself without a mesh)."""
        return nt if self.mesh is None else self.mesh.gather_rows(nt)

    def state_digest(self) -> str:
        """SHA-256 of the host index blob and every field of the store:
        equal on every rank of a mesh whose replay stayed in step."""
        h = hashlib.sha256(self.index.serialize().tobytes())
        for x in self.store:
            h.update(x.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def check_replicas(self) -> str:
        """All-gather state_digest() over the mesh and raise
        RuntimeError when two ranks differ. Returns the digest."""
        dg = self.state_digest()
        if self.mesh is None or self.mesh.group is None:
            return dg
        mine = torch.as_tensor(np.frombuffer(bytes.fromhex(dg), np.uint8),
                               device=self.device)
        every = self.mesh.all_gather(mine[None]).cpu().numpy()
        if (every != every[0]).any():
            raise RuntimeError(
                f"the mesh's replicas diverged: rank {self.mesh.rank} has "
                f"{dg}, the ranks have "
                f"{[bytes(r).hex()[:16] for r in every]}")
        return dg

    def _apply_newmeas(self, nm) -> int:
        """Dedup + insert new hits (GPisMap.cpp:492-568). Returns the
        number of inserted nodes."""
        ok = nm.insert_ok
        if not ok.any():
            return 0
        ids = self.index.try_insert(nm.pos[ok])
        ins = ids >= 0
        if ins.any():
            self.index.set_node_data(
                ids[ins], np.full(ins.sum(), -self.p.fbias, np.float32),
                nm.noise[ok][ins], nm.grad[ok][ins], nm.grad_noise[ok][ins])
        return int(ins.sum())

    def _apply_reeval(self, node_ids, rv) -> None:
        """Apply a host copy of a re-evaluation's per-node actions (rows
        beyond len(node_ids) are padding)."""
        n = len(node_ids)
        if n:
            self.index.apply_reeval(
                node_ids, rv.action[:n], rv.pos[:n], rv.grad[:n],
                rv.noise[:n], rv.grad_noise[:n], rv.dbl_pos_sig[:n],
                rv.dbl_grad_sig[:n], -self.p.fbias)

    # ------------------------------------------------------------------
    def _use_mirror(self) -> bool:
        """The device node mirror (retrain support gathered on the device
        by id): GPISMAP_NODE_MIRROR, read at each retrain; 0/off gathers
        the support on the host instead (the same values)."""
        return os.environ.get("GPISMAP_NODE_MIRROR", "1") not in (
            "0", "off")

    def _sync_mirror(self) -> None:
        """Scatter the nodes mutated since the last sync into the device
        node mirror; the first call after reset() or a load seeds it with
        every live node. Raises ValueError (from scatter_mirror) for a
        node id at or above cap.max_nodes, the mirror's length. With the
        mirror off it drops the mirror, so that turning it on again
        seeds a new one."""
        if not self._use_mirror():
            self._mirror = None
            return
        if self._mirror is None:
            self._mirror = cluster.make_mirror(self.cap, self.dim,
                                               self.device)
            self.index.pop_dirty()          # the full seed covers them
            nd = self.index.dump_nodes()
            ids = np.nonzero(nd["alive"])[0].astype(np.int32)
            nd = {k: v[ids] for k, v in nd.items()}
        else:
            ids = self.index.pop_dirty()
            nd = self.index.get_nodes(ids)
        if len(ids) == 0:
            return
        cluster.scatter_mirror(self._mirror, self._t(ids),
                               self._t(nd["pos"]), self._t(nd["grad"]),
                               self._t(nd["val"]), self._t(nd["pos_sig"]),
                               self._t(nd["grad_sig"]))

    def _retrain_store(self) -> None:
        """Retrain the touched cluster GPs (GPisMap.cpp:596-663) with
        support-count size buckets: each bucket fits at its own padding,
        which masked identity rows make equal to a full-padding fit up to
        f32 rounding (on the card about 1e-6 relative, bounded by
        tests/test_torch_chol.py::test_cuda_bucketed_fit_matches_full_padding:
        the [f; gx; gy] layout puts the padded rows inside the matrix, so
        the kernels' 64-wide blocks group the sums differently at the
        bucket's size and at full padding). The support is gathered on
        the device from the node mirror, or on the host with the mirror
        off. By default the factor cache is refreshed from the fits' own
        Cholesky factors; with a mesh or the mirror off the fits keep
        none and the cache re-factorizes the retrained cells. This is
        the JAX package's _retrain_store, its fused frame epilogue
        (frame_finish_full) run as its separate stages in the same
        order."""
        mcap = self.cap.gp_support
        with spans.span("retrain.collect"):
            rt = self.index.collect_retrain(self.p.gp_radius_times, mcap,
                                            self.cap.retrain_batch * 16)
        b = rt["n"]
        if rt["total"] > b:
            self.stats["retrain_truncated"] = rt["total"] - b
        with spans.span("retrain.mirror"):
            self._sync_mirror()
        counts = rt["counts"][:b]
        with spans.span("retrain.fit"):
            fit_ls = self._fit_buckets(rt, counts)
        with spans.span("retrain.grid"):
            self.index.clear_active()
            self._rebuild_grid()
        self._nbrs = None       # `trained` is baked in: rebuilt at test()
        with spans.span("retrain.refresh"):
            self._refresh_factors(rt["slots"][:b], counts, fit_ls)

    def _fit_buckets(self, rt: dict, counts: np.ndarray) -> list:
        """Fit the retrain set rt (collect_retrain; counts its first rows'
        support counts) bucket by bucket, in padded chunks. Returns
        [(padded slot rows, fit Cholesky factor)] per chunk, empty where
        the fits keep no factor (a mesh, or the mirror off)."""
        b = len(counts)
        mcap = self.cap.gp_support
        spans.factorizations("chol", counts, self.dim)
        keep_l = self.mesh is None and self._mirror is not None
        lo = 8 if self.mesh is None else max(8, self.mesh.size)
        fit_ls = []
        assigned = np.zeros(b, bool)
        for mb in self._retrain_buckets:
            selb = ~assigned if mb >= mcap else (~assigned) & (counts <= mb)
            assigned |= selb
            rows = np.nonzero(selb)[0]
            if not len(rows):
                continue
            chunk = min(self.cap.retrain_batch, _next_pow2(len(rows), lo=lo))
            for s in range(0, len(rows), chunk):
                rr = rows[s:s + chunk]
                sup = np.full((chunk, mb), -1, np.int32)
                sup[:len(rr)] = rt["support"][rr][:, :mb]
                slots = np.full(chunk, -1, np.int32)
                slots[:len(rr)] = rt["slots"][rr]
                if keep_l:
                    self.store, l = cluster.retrain_cells_from_mirror_with_l(
                        self.store, self._mirror, self._t(slots),
                        self._t(slots >= 0), self._t(sup),
                        self.p.map_scale_param)
                    fit_ls.append((slots, l))
                else:
                    self._retrain_chunk(slots, sup)
        return fit_ls

    def _retrain_chunk(self, slots: np.ndarray, sup: np.ndarray) -> None:
        """Fit one padded retrain chunk without keeping its Cholesky
        factor: this rank's rows of it (all of them without a mesh), the
        support gathered from the node mirror or, with the mirror off, on
        the host; the fitted rows are all-gathered and scattered into the
        store, the same on every rank."""
        rows = slice(None) if self.mesh is None else \
            self.mesh.local_rows(len(slots))
        sup_l = sup[rows]
        if self._mirror is not None:
            data = cluster.mirror_support(self._mirror, self._t(sup_l))
        else:
            nd = self.index.get_nodes(sup_l.reshape(-1))
            shp = sup_l.shape
            data = (self._t(nd["pos"].reshape(shp + (self.dim,))),
                    self._t(nd["grad"].reshape(shp + (self.dim,))),
                    self._t(nd["val"].reshape(shp)),
                    self._t(nd["pos_sig"].reshape(shp)),
                    self._t(nd["grad_sig"].reshape(shp)),
                    self._t(sup_l >= 0))
        fitted, _ = cluster.fit_cells(*data, self.p.map_scale_param,
                                      self.cap.gp_support)
        self.store = cluster.scatter_cells(
            self.store, self._t(slots), self._t(slots >= 0),
            self._gather(fitted))

    def _rebuild_grid(self) -> None:
        """Dense cluster grid rebuilt on the device from the live cells."""
        cells = self.index.all_cluster_cells(cap=self.cap.max_cells * 4)
        n = 0
        if len(cells):
            centers, _, slots = self.index.cell_info(cells)
            live = slots >= 0
            n = int(live.sum())
        cpad = _next_pow2(max(n, 1))
        cc = np.zeros((cpad, self.dim), np.int32)
        sl = np.full(cpad, -1, np.int32)
        if n:
            cc[:n] = np.floor(centers[live] / self.cell_size).astype(
                np.int32)
            sl[:n] = slots[live]
        self.grid = cluster.build_grid_device(self._t(cc), self._t(sl),
                                              self.dim, self.grid_half)

    def _live_slots(self) -> np.ndarray:
        """Sorted live cluster slots (the factor-cache key)."""
        cells = self.index.all_cluster_cells(cap=self.cap.max_cells * 4)
        if len(cells) == 0:
            return np.zeros(0, np.int32)
        _, _, slots = self.index.cell_info(cells)
        return np.sort(slots[slots >= 0]).astype(np.int32)

    def _get_factors(self):
        """Cached per-cell L^-1 of all live cells (the reference keeps L
        per cell, OnGPIS.h), filled at the first test() after a change of
        the live slot set and refreshed by each retrain; None (per-call
        factorization) when the live cells exceed the cache bound."""
        with spans.span("test.factors"):
            if self._factors is not None:
                return self._factors
            live = self._live_slots()
            if len(live) == 0 or len(live) > self.cap.test_active_cells:
                return None
            pad = np.full(self.cap.test_active_cells, -1, np.int32)
            pad[:len(live)] = live
            pad = self._t(pad)
            self._count_factorizations(pad, "chol", "linv")
            self._factors = cluster.factorize_slots(
                self.store, pad, self.p.map_scale_param,
                self.cap.test_active_cells)
            self._factors_slots = live
            return self._factors

    def _count_factorizations(self, slots: torch.Tensor, *kinds) -> None:
        """While a profiler records, count the cells of the padded slot
        rows `slots` (device; -1 pads) as handed to each of `kinds`, at
        their supports in the store, on the device: no read-back."""
        if spans.on():
            m = self.store.valid[slots].sum(-1) * (slots >= 0)
            for kind in kinds:
                spans.factorizations(kind, m, self.dim)

    def _refresh_buckets(self) -> tuple:
        """The refresh sizes of update_factors: at most two groups, the
        largest refresh_bucket below capacity, then the full capacity
        (None). The JAX package keeps two because every chained refresh
        holds a copy of the cache (3D: 2.1 GB) until the chain ends; the
        port refreshes in place, and keeps its groups."""
        subs = [cluster.refresh_bucket(b, self.cap.gp_support, self.dim)
                for b in self._retrain_buckets]
        subs = sorted({s for s in subs if s is not None})
        return ((subs[-1],) if subs else ()) + (None,)

    def _refresh_factors(self, retrained_slots: np.ndarray,
                         counts: np.ndarray, fit_ls) -> None:
        """Factor-cache upkeep after a retrain. If the live slot set is
        unchanged since the cache was filled, only the retrained cells'
        factors are refreshed, so the next test() skips the full refill;
        any change of the slot set (a new cell, a pruned one) drops the
        cache.

        fit_ls: (padded slot rows, l) per retrain chunk: the refresh
        inverts the fits' own Cholesky factors (update_factors_from_l).
        Empty (a mesh, or the mirror off), the retrained slots
        re-factorize grouped by refresh bucket of their support counts
        (update_factors)."""
        old, self._factors = self._factors, None
        if old is None or self._factors_slots is None:
            self._factors_slots = None
            return
        live = self._live_slots()
        if (len(live) == 0 or len(live) > self.cap.test_active_cells
                or not np.array_equal(live, self._factors_slots)):
            self._factors_slots = None
            return
        linv_buf, uniq = old
        for slots, l in fit_ls:
            slots = self._t(slots)
            self._count_factorizations(slots, "linv")
            linv_buf = cluster.update_factors_from_l(
                linv_buf, uniq, slots, l, d=self.dim)
        if not fit_ls and len(retrained_slots):
            assigned = np.zeros(len(retrained_slots), bool)
            for mb in self._refresh_buckets():
                sel = ~assigned if mb is None else (~assigned) & (counts
                                                                  <= mb)
                assigned |= sel
                if not sel.any():
                    continue
                sl_np = retrained_slots[sel]
                sl = np.full(_next_pow2(len(sl_np), lo=8), -1, np.int32)
                sl[:len(sl_np)] = sl_np
                sl = self._t(sl)
                self._count_factorizations(sl, "chol", "linv")
                linv_buf = cluster.update_factors(
                    self.store, linv_buf, uniq, sl,
                    self.p.map_scale_param, mb=mb)
        self._factors = (linv_buf, uniq)

    # ------------------------------------------------------------------
    def _use_nbr_table(self) -> bool:
        """Whether test() takes the candidate table: GPISMAP_NBR_TABLE,
        read at each test(), 1/on; unset ("auto"), 0 or off leave it off
        on every device."""
        return os.environ.get("GPISMAP_NBR_TABLE", "auto") in ("1", "on")

    def _pallas_bf16(self) -> bool:
        """Whether test() runs the tile kernel's bf16 variance variant:
        GPISMAP_PALLAS_BF16, read at each test(), 1/on, and a mapper on a
        CUDA device (the JAX package passes `up and _pallas_bf16()`,
        where up is false off its accelerator). Off by default: the
        variance error can flip the var_thre blend (PERF.md)."""
        return (self.device.type == "cuda" and os.environ.get(
            "GPISMAP_PALLAS_BF16") in ("1", "on"))

    def _build_nbrs(self) -> None:
        """Build the candidate table from the live cells (None when no
        cell is live). The dense variant, one row per grid cell, is taken
        when the grid has at most 2^18 cells."""
        self._nbrs = None
        cells = self.index.all_cluster_cells(cap=self.cap.max_cells * 4)
        if len(cells) == 0:
            return
        centers, _, slots = self.index.cell_info(cells)
        live = slots >= 0
        n = int(live.sum())
        if n == 0:
            return
        cpad = _next_pow2(n)
        cc = np.zeros((cpad, self.dim), np.int32)
        sl = np.full(cpad, -1, np.int32)
        cc[:n] = np.floor(centers[live] / self.cell_size).astype(np.int32)
        sl[:n] = slots[live]
        self._nbr_dense = (2 * self.grid_half) ** self.dim <= (1 << 18)
        self._nbrs = cluster.build_neighbor_table(
            self._t(cc), self._t(sl), self.store.trained, self.grid_half,
            self._noff, self.cap.nbr_k, self._nbr_dense)

    def test(self, x: np.ndarray) -> np.ndarray:
        """Batched SDF query (GPisMap::test, GPisMap.cpp:765-810;
        GPisMap3::test, GPisMap3.cpp:904-949).

        x: [N, D] world points. Returns [N, 2 + 2D]: [f, grad (D),
        var_f, var_grad (D)], with the unmapped sentinel var_f =
        1 + map_noise (GPisMap.cpp:685). With a mesh every rank passes
        the same x, evaluates its shard of it and returns all of it.
        """
        x = np.asarray(x, np.float32).reshape(-1, self.dim)
        nq = x.shape[0]
        # pad with a far-away point: padded queries get no candidate cells
        xq = np.full((_next_pow2(nq), self.dim), 1e6, np.float32)
        xq[:nq] = x
        if not self._use_nbr_table():
            self._nbrs = None
        elif self._nbrs is None:
            with spans.span("test.candidates"):
                self._build_nbrs()
        # the queries go up before the factor-cache fill is enqueued: a
        # copy from pageable memory waits for the device's queue
        q = self._t(xq)
        factors = self._get_factors()
        run = cluster.map_test if self.mesh is None else functools.partial(
            cluster.map_test_sharded, mesh=self.mesh)
        f, g, vf, vg, info = run(
            self.store, self.grid, q, factors=factors,
            nbrs=self._nbrs, nbr_dense=self._nbr_dense,
            bf16=self._pallas_bf16(), **self._test_kwargs())
        with spans.span("test.readback"):
            out = torch.cat([f[:, None], g, vf[:, None], vg],
                            dim=-1)[:nq].cpu()
            info = _to_numpy(info)
        # candidates beyond cap.nbr_k a table row could not hold
        if self._nbrs is not None and int(self._nbrs.n_overflow):
            self.stats["nbr_overflow"] = int(self._nbrs.n_overflow)
        self.stats["test_eval_pairs"] = int(info.n_pairs)
        self.stats["test_phase2_queries"] = int(info.n_phase2)
        if int(info.n_dropped):
            # max_active overflow dropped evaluations
            self.stats["test_dropped_pairs"] = (
                self.stats.get("test_dropped_pairs", 0)
                + int(info.n_dropped))
        return out.numpy()

    # ------------------------------------------------------------------
    def get_all_points(self) -> np.ndarray:
        """All live surface-node positions."""
        d = self.index.dump_nodes()
        return d["pos"][d["alive"]]

    @property
    def num_nodes(self) -> int:
        return self.index.num_nodes


class GPisMap2D(_MapperBase):
    """Online continuous 2D SDF mapper from LiDAR scans.

    update(thetas, ranges, pose6) ingests one scan with pose
    [tx, ty, R00, R10, R01, R11] (column-major 2x2, mexGPisMap.cpp:57-67);
    test(x) returns [N, 6] = [f, gx, gy, var_f, var_gx, var_gy]
    (mexGPisMap.cpp:99). All GP state and math live on `device`, a CUDA
    card unless the caller asks for the CPU; the spatial index lives on
    the host.

    strict_reeval=True replays the reference's per-cell order of the
    re-evaluation (GPisMap.cpp:192-229): one reeval_2d per in-view cell,
    each cell's nodes gathered after the earlier cells' mutations, so a
    node moved forward is re-evaluated again. The default evaluates one
    snapshot of the in-view nodes in the frame's single device pass.

    mesh (parallel.mesh.Mesh) runs the loop on every rank of the mesh
    (see _MapperBase): the beams' new-measurement evaluation and the
    nodes' re-evaluation are split over the ranks and all-gathered; the
    preprocess and the observation-GP fit run replicated. device
    defaults to the card, or to the mesh's device.
    """

    def __init__(self, params: MapperParam = MAPPER_2D,
                 obs_param: ObsGPParam = OBSGP_1D,
                 tree: TreeParam = TREE_2D,
                 cap: CapacityParam = CAPACITY_2D,
                 strict_reeval: bool = False,
                 device: torch.device | str | None = None,
                 mesh=None):
        self.strict_reeval = strict_reeval
        # test search box: map_scale * 4 (GPisMap.cpp:680)
        self._setup(params, obs_param, tree, cap, 2, device,
                    search_half=params.map_scale_param * 4.0, mesh=mesh)

    # ------------------------------------------------------------------
    def update(self, thetas: np.ndarray, ranges: np.ndarray,
               pose: np.ndarray) -> None:
        """Ingest one scan (GPisMap::update, GPisMap.cpp:151-167). Per-frame
        counters land in self.stats."""
        with spans.span("update.prep"):
            thetas = np.asarray(thetas, np.float32).reshape(-1)
            ranges = np.asarray(ranges, np.float32).reshape(-1)
            pose = np.asarray(pose, np.float32).reshape(-1)
            tr = pose[:2]
            rot = pose[2:6].reshape(2, 2, order="F")

            nb = _next_pow2(len(thetas))
            th_p = np.zeros(nb, np.float32)
            rg_p = np.zeros(nb, np.float32)  # padded beams: range 0, gated
            th_p[:len(thetas)] = thetas
            rg_p[:len(ranges)] = ranges
            # host range gate (the same as preprocess_2d's) for the cull
            validh = (rg_p > self.p.min_range) & (rg_p < self.p.max_range)
            n_valid = int(validh.sum())
            if n_valid <= 1:       # preproData failure (GPisMap.cpp:145-148)
                return
            rmax = float(rg_p[validh].max())
            g_max = nb // self.op.group_size + 2
            # with a mesh, new measurements of this rank's beams
            rows = None if self.mesh is None else self.mesh.local_rows(nb)

        if self.strict_reeval:
            with spans.span("update.frame"):
                _, obs, nm = mapper2d.frame_compute_2d(
                    self._t(th_p), self._t(rg_p), self._t(tr), self._t(rot),
                    self.p, self.op, g_max=g_max, rows=rows)
                nm = _to_numpy(self._gather(nm))
            with spans.span("update.cull"):
                cells = self._inview_cells(tr, rot, rmax)
            steps = 0
            for c in cells:
                with spans.span("update.cull"):
                    ids = self.index.cell_nodes(c)
                steps += self._reeval_apply(obs, ids, tr, rot)
        else:
            with spans.span("update.cull"):
                node_ids = self._inview_node_ids(tr, rot, rmax)
                sel, nvalid = _pad_ids(node_ids)
                d = self.index.get_nodes(sel)
            with spans.span("update.frame"):
                args = ((self._t(th_p), self._t(rg_p), self._t(tr),
                         self._t(rot))
                        + tuple(self._shard(self._t(d[k])) for k in
                                ("pos", "grad", "pos_sig", "grad_sig"))
                        + (self._shard(self._t(nvalid)), self.p, self.op))
                if self.mesh is None:
                    # the frame's outputs in one packed buffer, read back
                    # in one copy and split on the host
                    buf = mapper2d.frame_update_2d(*args, g_max=g_max,
                                                   packed=True)
                    rv, nm = mapper2d.unpack_frame_2d(buf.cpu().numpy(),
                                                      len(sel), nb)
                else:
                    rv, nm = mapper2d.frame_update_2d(*args, g_max=g_max,
                                                      rows=rows)
                    rv = _to_numpy(self._gather(rv))
                    nm = _to_numpy(self._gather(nm))
            steps = int(rv.steps[:len(node_ids)].sum())
        with spans.span("update.replay"):
            if not self.strict_reeval:
                self._apply_reeval(node_ids, rv)
            n_new = self._apply_newmeas(nm)

        self._retrain_store()
        self.stats.update(
            frame=self.frame, n_valid_beams=n_valid,
            n_nodes=self.index.num_nodes, reeval_steps=steps,
            n_cluster_cells=int(self.index.max_slot),
            new_inserted=n_new,
            support_overflow=int(self.index.overflow_count))
        self.frame += 1

    def update_batch(self, frames) -> None:
        """Ingest several scans: frames is an iterable of (thetas, ranges,
        pose6), the same as calling update() on each in turn."""
        for th, rg, pose in frames:
            self.update(th, rg, pose)

    def _inview_cells(self, tr, rot, rmax):
        """Cluster cells passing the range + FOV culls
        (GPisMap.cpp:184-222), in reference traversal order."""
        if self.index.num_nodes == 0:
            return np.zeros(0, np.int32)
        cells, _ = self.index.query_cluster_cells(tr, rmax, cap=65536)
        if len(cells) == 0:
            return cells
        centers, halfs, _ = self.index.cell_info(cells)
        # range cull (GPisMap.cpp:196-199)
        sqr = np.sum((centers - tr) ** 2, -1)
        keep = sqr <= rmax * rmax + 2.0 * halfs * halfs
        # FOV cull by cell corners (GPisMap.cpp:202-222)
        corners = centers[:, None, :] + halfs[:, None, None] * np.array(
            [[-1, 1], [1, 1], [-1, -1], [1, -1]], np.float32)
        loc = (corners - tr) @ rot
        loc = loc - np.asarray(self.p.sensor_offset, np.float32)
        ang = np.arctan2(loc[..., 1], loc[..., 0])
        lim = self.p.angle_obs_limit
        keep &= np.any((ang > lim[0]) & (ang < lim[1]), axis=-1)
        return cells[keep]

    def _inview_node_ids(self, tr, rot, rmax):
        cells = self._inview_cells(tr, rot, rmax)
        if len(cells) == 0:
            return np.zeros(0, np.int32)
        return np.concatenate([self.index.cell_nodes(c) for c in cells])

    def _reeval_apply(self, obs, node_ids, tr, rot) -> int:
        """reeval_2d of one cell's nodes against the frame's observation
        GP, applied on the host index (the strict mode's step); with a
        mesh, of this rank's rows, all-gathered. Returns the nodes'
        re-localization steps."""
        if len(node_ids) == 0:
            return 0
        with spans.span("update.cull"):
            sel, valid = _pad_ids(node_ids)
            d = self.index.get_nodes(sel)
        with spans.span("update.reeval"):
            rv = mapper2d.reeval_2d(
                obs, *(self._shard(self._t(d[k])) for k in
                       ("pos", "grad", "pos_sig", "grad_sig")),
                self._shard(self._t(valid)), self._t(tr), self._t(rot),
                self.p, self.op)
            rv = _to_numpy(self._gather(rv))
        with spans.span("update.replay"):
            self._apply_reeval(node_ids, rv)
        return int(rv.steps[:len(node_ids)].sum())

    # ------------------------------------------------------------------
    def _test_kwargs(self) -> dict:
        """The 2D query constants (GPisMap.cpp:671,685; OnGPIS.cpp:170-172)."""
        return dict(
            cell_size=self.cell_size, grid_half=self.grid_half,
            noff=self._noff, search_half=self._search_half,
            scale=self.p.map_scale_param, val_const=1.01,
            grad_const=self.p.three_over_scale + 0.1,
            var_thre=self.p.test_var_thre,
            default_var=1.0 + self.p.map_noise_param,
            tile=self.cap.test_tile, max_cells=self.cap.max_cells,
            max_active=self.cap.test_active_cells)
