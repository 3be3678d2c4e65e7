"""User-facing 2D online GPIS mapper on PyTorch, and the host
orchestration both mappers share.

Port of gpismap_tpu/api.py:GPisMap2D (snapshot and strict re-evaluation)
and of the dimension-free parts of its _MeshMixin and _retrain_store
(without the mesh). A host orchestrator that drives:
  * the native spatial index (csrc/gpis_index.cpp) for tree mutations
  * the per-frame tensor stages (models/mapper2d.py) for the GP math
  * the cluster-GP store, the node mirror and the factor cache
    (models/cluster.py) for the retrain and test()
on one torch device.

With GPISMAP_NBR_TABLE=1, test() finds each query's candidate cells
through a precomputed candidate table (cluster.NeighborTable), as the
JAX package does by default on its accelerator; the results are the
window path's. Unset, the table is off on every device: on the H100 it
saves no query time and costs its build at the first test() after each
retrain (PERF.md).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .config import (CAPACITY_2D, MAPPER_2D, OBSGP_1D, TREE_2D,
                     CapacityParam, MapperParam, ObsGPParam, TreeParam)
from .models import cluster, mapper2d
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
    checks, map reset, the new-measurement insert, the node mirror, the
    bucketed retrain, the cluster grid, the factor cache and test() (the
    JAX package's _MeshMixin and _retrain_store, without the mesh).

    A subclass sets params, the dimension and the test search box
    through _setup, and supplies update() and the test constants
    (_test_kwargs). The candidate table, when GPISMAP_NBR_TABLE turns
    it on, is built at the first test() after a change of the map and
    dropped by every retrain, reset and load."""

    def _setup(self, params: MapperParam, obs_param: ObsGPParam,
               tree: TreeParam, cap: CapacityParam, dim: int,
               device: torch.device | str, search_half: float) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}(device="
                               f"'{self.device}'): no CUDA device is "
                               f"available; pass device='cpu' to run on "
                               f"the CPU")
        self.p = params
        self.op = obs_param
        self.tp = tree
        self.cap = cap
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

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

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
    def _sync_mirror(self) -> None:
        """Scatter the nodes mutated since the last sync into the device
        node mirror; the first call after reset() or a load seeds it with
        every live node. Raises ValueError (from scatter_mirror) for a
        node id at or above cap.max_nodes, the mirror's length."""
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
        the device from the node mirror,
        and the factor cache is refreshed from the fits' own Cholesky
        factors. This is the JAX package's fused frame epilogue
        (frame_finish_full), run as its separate stages in the same order."""
        mcap = self.cap.gp_support
        rt = self.index.collect_retrain(self.p.gp_radius_times, mcap,
                                        self.cap.retrain_batch * 16)
        b = rt["n"]
        if rt["total"] > b:
            self.stats["retrain_truncated"] = rt["total"] - b
        self._sync_mirror()
        fit_ls = []            # (padded slot rows, fit Cholesky factor)
        counts = rt["counts"][:b]
        assigned = np.zeros(b, bool)
        for mb in self._retrain_buckets:
            selb = ~assigned if mb >= mcap else (~assigned) & (counts <= mb)
            assigned |= selb
            rows = np.nonzero(selb)[0]
            if not len(rows):
                continue
            chunk = min(self.cap.retrain_batch, _next_pow2(len(rows), lo=8))
            for s in range(0, len(rows), chunk):
                rr = rows[s:s + chunk]
                sup = np.full((chunk, mb), -1, np.int32)
                sup[:len(rr)] = rt["support"][rr][:, :mb]
                slots = np.full(chunk, -1, np.int32)
                slots[:len(rr)] = rt["slots"][rr]
                self.store, l = cluster.retrain_cells_from_mirror_with_l(
                    self.store, self._mirror, self._t(slots),
                    self._t(slots >= 0), self._t(sup),
                    self.p.map_scale_param)
                fit_ls.append((slots, l))
        self.index.clear_active()
        self._rebuild_grid()
        self._nbrs = None       # `trained` is baked in: rebuilt at test()
        self._refresh_factors(fit_ls)

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
        if self._factors is not None:
            return self._factors
        live = self._live_slots()
        if len(live) == 0 or len(live) > self.cap.test_active_cells:
            return None
        pad = np.full(self.cap.test_active_cells, -1, np.int32)
        pad[:len(live)] = live
        self._factors = cluster.factorize_slots(
            self.store, self._t(pad), self.p.map_scale_param,
            self.cap.test_active_cells)
        self._factors_slots = live
        return self._factors

    def _refresh_factors(self, fit_ls) -> None:
        """Factor-cache upkeep after a retrain. If the live slot set is
        unchanged since the cache was filled, only the retrained cells'
        factors are refreshed, from the fits' own Cholesky factors
        (fit_ls: (padded slot rows, l) per retrain chunk; empty when
        nothing retrained), so the next test() skips the full refill; any
        change of the slot set (a new cell, a pruned one) drops the
        cache."""
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
            linv_buf = cluster.update_factors_from_l(
                linv_buf, uniq, self._t(slots), l, d=self.dim)
        self._factors = (linv_buf, uniq)

    # ------------------------------------------------------------------
    def _use_nbr_table(self) -> bool:
        """Whether test() takes the candidate table: GPISMAP_NBR_TABLE,
        read at each test(), 1/on; unset ("auto"), 0 or off leave it off
        on every device."""
        return os.environ.get("GPISMAP_NBR_TABLE", "auto") in ("1", "on")

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
        1 + map_noise (GPisMap.cpp:685).
        """
        x = np.asarray(x, np.float32).reshape(-1, self.dim)
        nq = x.shape[0]
        # pad with a far-away point: padded queries get no candidate cells
        xq = np.full((_next_pow2(nq), self.dim), 1e6, np.float32)
        xq[:nq] = x
        if not self._use_nbr_table():
            self._nbrs = None
        elif self._nbrs is None:
            self._build_nbrs()
        f, g, vf, vg, info = cluster.map_test(
            self.store, self.grid, self._t(xq), factors=self._get_factors(),
            nbrs=self._nbrs, nbr_dense=self._nbr_dense,
            **self._test_kwargs())
        out = torch.cat([f[:, None], g, vf[:, None], vg], dim=-1)[:nq].cpu()
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
    """

    def __init__(self, params: MapperParam = MAPPER_2D,
                 obs_param: ObsGPParam = OBSGP_1D,
                 tree: TreeParam = TREE_2D,
                 cap: CapacityParam = CAPACITY_2D,
                 strict_reeval: bool = False,
                 device: torch.device | str = "cuda"):
        self.strict_reeval = strict_reeval
        # test search box: map_scale * 4 (GPisMap.cpp:680)
        self._setup(params, obs_param, tree, cap, 2, device,
                    search_half=params.map_scale_param * 4.0)

    # ------------------------------------------------------------------
    def update(self, thetas: np.ndarray, ranges: np.ndarray,
               pose: np.ndarray) -> None:
        """Ingest one scan (GPisMap::update, GPisMap.cpp:151-167). Per-frame
        counters and timings land in self.stats."""
        t0 = time.time()
        thetas = np.asarray(thetas, np.float32).reshape(-1)
        ranges = np.asarray(ranges, np.float32).reshape(-1)
        pose = np.asarray(pose, np.float32).reshape(-1)
        tr = pose[:2]
        rot = pose[2:6].reshape(2, 2, order="F")

        nb = _next_pow2(len(thetas))
        th_p = np.zeros(nb, np.float32)
        rg_p = np.zeros(nb, np.float32)     # padded beams: range 0, gated out
        th_p[:len(thetas)] = thetas
        rg_p[:len(ranges)] = ranges
        # host range gate (the same as preprocess_2d's) for the in-view cull
        validh = (rg_p > self.p.min_range) & (rg_p < self.p.max_range)
        n_valid = int(validh.sum())
        if n_valid <= 1:           # preproData failure (GPisMap.cpp:145-148)
            return
        rmax = float(rg_p[validh].max())
        g_max = nb // self.op.group_size + 2

        if self.strict_reeval:
            _, obs, nm = mapper2d.frame_compute_2d(
                self._t(th_p), self._t(rg_p), self._t(tr), self._t(rot),
                self.p, self.op, g_max=g_max)
            for c in self._inview_cells(tr, rot, rmax):
                self._reeval_apply(obs, self.index.cell_nodes(c), tr, rot)
            nm = _to_numpy(nm)
        else:
            node_ids = self._inview_node_ids(tr, rot, rmax)
            sel, nvalid = _pad_ids(node_ids)
            d = self.index.get_nodes(sel)
            rv, nm = mapper2d.frame_update_2d(
                self._t(th_p), self._t(rg_p), self._t(tr), self._t(rot),
                self._t(d["pos"]), self._t(d["grad"]), self._t(d["pos_sig"]),
                self._t(d["grad_sig"]), self._t(nvalid), self.p, self.op,
                g_max=g_max)
            rv, nm = _to_numpy(rv), _to_numpy(nm)
            self._apply_reeval(node_ids, rv)
        n_new = self._apply_newmeas(nm)

        t1 = time.time()
        self._retrain_store()
        self.stats.update(
            frame=self.frame, n_valid_beams=n_valid,
            n_nodes=self.index.num_nodes,
            n_cluster_cells=int(self.index.max_slot),
            new_inserted=n_new,
            support_overflow=int(self.index.overflow_count),
            update_s=round(time.time() - t0, 4),
            retrain_s=round(time.time() - t1, 4))
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

    def _reeval_apply(self, obs, node_ids, tr, rot) -> None:
        """reeval_2d of one cell's nodes against the frame's observation
        GP, applied on the host index (the strict mode's step)."""
        if len(node_ids) == 0:
            return
        sel, valid = _pad_ids(node_ids)
        d = self.index.get_nodes(sel)
        rv = mapper2d.reeval_2d(
            obs, self._t(d["pos"]), self._t(d["grad"]),
            self._t(d["pos_sig"]), self._t(d["grad_sig"]), self._t(valid),
            self._t(tr), self._t(rot), self.p, self.op)
        self._apply_reeval(node_ids, _to_numpy(rv))

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
