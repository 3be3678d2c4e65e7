"""One run of one cell: the scene and sensor of its configuration, the
loop of its traffic mix, the check of what the timed calls returned, and
the metrics its readers take from the run.

Everything that belongs to one configuration, one traffic mix or one
metric is data or a reader of its own, found by name:
configs/<config>.json, traffic/<traffic>.json, limits/<workload>.json and
metrics/<metric>.py under the benchmark's folder.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import reference, scenes, trace, truth, update_ref, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def reader(name: str):
    """The reader of metric `name`: metrics/<name>.py's read(ctx)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _seed(*parts) -> list:
    """A numpy seed sequence entropy from the run's seed and labels."""
    return [int(p) % (1 << 63) for p in parts]


def _torch_seed(*parts) -> int:
    return int(np.random.SeedSequence(_seed(*parts)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def check_pairs(seed: int, n_frames: int, mix: dict) -> list:
    """The (episode, frame) pairs a stream's check reads, in the order it
    reads them, drawn from the seed alone: mix["pairs"] of them from the
    first mix["pair_episodes"] episodes, which every sound window on the
    card finishes. The first is an episode's last frame (the largest map).
    A first frame, which finds no map, is never drawn: its inserts are
    most of a percentile's pool wherever it is in it, and would hide a
    fault of the later frames."""
    rng = np.random.default_rng(_seed(seed, 7))
    first = (int(rng.integers(mix["pair_episodes"])), n_frames - 1)
    rest = [(e, j) for e in range(mix["pair_episodes"])
            for j in range(1, n_frames) if (e, j) != first]
    order = rng.permutation(len(rest))[:mix["pairs"] - 1]
    return [first] + [rest[int(i)] for i in order]


# ---- configurations ------------------------------------------------------
class Scene:
    """A configuration's sensor, frame schedule and query set, made from
    its file."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        self.dim = cfg["dim"]
        sc, se, qu = cfg["scene"], cfg["sensor"], cfg["query"]
        self.noise = se["noise_m"]
        if self.dim == 2:
            self.lidar = scenes.Lidar(se)
            self.walls = scenes.PLANS[sc["plan"]]()
            poses = scenes.path_poses(sc["path"], sc["frames"])
            self.thetas, self.ranges, self.p6 = scenes.scan_truth(
                self.walls, poses, self.lidar)
            self.n_frames = len(self.p6)
            self.grid = scenes.grid_2d(*qu["x"], *qu["y"], qu["step"])
        else:
            self.cam = SimpleNamespace(**se["camera"])
            self.poses = scenes.ring_poses(sc["ring"])[:sc["frames"]]
            self.depth = scenes.depth_truth(self.poses, self.cam, device)
            self.n_frames = len(self.poses)
            self.grid = scenes.grid_3d(qu["x"], qu["y"], qu["z"],
                                       qu["step"])
        if len(self.grid) != qu["points"]:
            raise ValueError(f"{cfg['name']}: the query set has "
                             f"{len(self.grid)} points, the configuration "
                             f"states {qu['points']}")
        self.step = qu["step"]

    def episode(self, seed: int, episode: int):
        """The frames of one episode, with its own sensor noise drawn from
        (seed, episode): [(update() arguments)]."""
        if self.dim == 2:
            rng = np.random.default_rng(_seed(seed, episode))
            return [(th, r, p) for th, r, p in scenes.noisy_scans(
                self.thetas, self.ranges, self.p6, self.noise, rng,
                self.lidar)]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_torch_seed(seed, episode))
        dep = scenes.noisy_depth(self.depth, self.noise,
                                 self.cfg["sensor"]["quantum_m"],
                                 gen).cpu().numpy()
        return [(dep[i], self.poses[i]) for i in range(self.n_frames)]

    def hits(self, frames) -> torch.Tensor:
        """True hit points [K, D] of the given frame indices, in the
        mapper's range gate (3D: every check_skip-th pixel)."""
        gp = self.cfg["gp"]
        if self.dim == 2:
            r = self.ranges[frames]
            r = np.where((r > gp["min_range"]) & (r < gp["max_range"]), r,
                         self.lidar.max_range)
            return torch.as_tensor(scenes.hit_points_2d(
                self.thetas, r, self.p6[frames], self.lidar))
        z = self.depth[frames]
        z = torch.where((z > gp["min_range"]) & (z < gp["max_range"]), z,
                        torch.inf)
        return scenes.hit_points_3d(z, self.poses[frames], self.cam,
                                    self.cfg["check"]["pixel_skip"])

    def candidates(self, cap) -> dict:
        """The reference's candidate node of each beam or pixel of the
        captured frame."""
        up, obs = self.cfg["update"], self.cfg["obs"]
        if self.dim == 2:
            return update_ref.scan_candidates(*cap["args"], up, obs,
                                              self.device)
        return update_ref.depth_candidates(*cap["args"], self.cam, up, obs,
                                           self.device)

    def frame_numbers(self, cap, cand=None) -> dict:
        """The map after the captured frame against the reference's
        account of the frame: its candidates (`cand` in their place where
        given) and the re-evaluation of the map before it."""
        cfg = self.cfg
        opts = cfg["mapper"]["options"]
        strict = opts.get("strict_reeval", False) if self.dim == 2 \
            else opts["reeval_mode"] != "snapshot"
        own = self.candidates(cap)
        ref = update_ref.reeval(cap["before"], own, cfg["update"],
                                cfg["tree"], strict)
        return update_ref.compare_frame(
            cap["before"], cap["nodes"], own if cand is None else cand, ref,
            cfg["check"], cfg["tree"], self.device)

    def map_numbers(self, nodes_pos, frames) -> dict:
        return truth.map_numbers(self, nodes_pos, self.hits(frames),
                                 self.cfg["check"]["cover_radius_m"],
                                 self.device)


def gp_spec(cfg: dict) -> reference.GPSpec:
    g = cfg["gp"]
    return reference.GPSpec(
        dim=cfg["dim"], scale=g["scale"], cell_size=g["cell_size"],
        radius_times=g["radius_times"], support_cap=g["support_cap"],
        search_half=g["search_half"], val_const=g["val_const"],
        grad_const=g["grad_const"], var_thre=g["var_thre"],
        default_var=g["default_var"])


def make_mapper(cfg: dict, device):
    """The program's mapper, built from the parameter sets the
    configuration names; raises where they differ from the numbers the
    configuration states (which the reference uses)."""
    import gpismap_tpu_torch as prog
    from gpismap_tpu_torch import config as pc
    mc = cfg["mapper"]
    params = getattr(pc, mc["params"])
    tree = getattr(pc, mc["tree"])
    cap = dataclasses.replace(getattr(pc, mc["capacity"]),
                              **mc.get("capacity_overrides", {}))
    m = getattr(prog, mc["class"])(
        params=params, obs_param=getattr(pc, mc["obs"]), tree=tree, cap=cap,
        device=device, **mc.get("options", {}))
    if "camera" in cfg["sensor"]:
        m.set_camera(pc.CameraParam(**cfg["sensor"]["camera"]))
    g = cfg["gp"]
    kw = m._test_kwargs()
    stated = dict(scale=params.map_scale_param, cell_size=kw["cell_size"],
                  radius_times=params.gp_radius_times,
                  support_cap=cap.gp_support, search_half=kw["search_half"],
                  val_const=kw["val_const"], grad_const=kw["grad_const"],
                  var_thre=kw["var_thre"], default_var=kw["default_var"],
                  min_range=params.min_range, max_range=params.max_range)
    want = dict(g)
    for sec, obj in (("update", params), ("obs", getattr(pc, mc["obs"])),
                     ("tree", tree)):
        for k, v in cfg[sec].items():
            stated[f"{sec}.{k}"] = getattr(obj, k)
            want[f"{sec}.{k}"] = v
    for k, v in stated.items():
        if not np.allclose(np.asarray(v, float), np.asarray(want[k], float),
                           rtol=1e-12, atol=0):
            raise ValueError(f"{cfg['name']}: the program's {k} = {v}, the "
                             f"configuration states {want[k]}")
    return m


def snapshot(m) -> dict:
    """The map's live nodes (a host copy)."""
    nd = m.index.dump_nodes()
    a = nd["alive"]
    return {k: nd[k][a].copy() for k in
            ("pos", "grad", "val", "pos_sig", "grad_sig")}


# ---- the run ---------------------------------------------------------------
class Run:
    """One run of a workload of BENCHMARK.json."""

    def __init__(self, bench: dict, workload: str, seed: int,
                 seconds: float, traced: bool, device, setup_clock):
        cells = {w["name"]: w for w in bench["workloads"]}
        self.cell = cells[workload]
        self.bench = bench
        self.cfg = load_json("configs", f"{self.cell['config']}.json")
        self.mix = load_json("traffic", f"{self.cell['traffic']}.json")
        self.limits = load_json("limits", f"{workload}.json")
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = torch.device(device)
        self.setup_clock = setup_clock
        self.spans = {"update": [], "test": []}
        self.latencies = []
        self.captures = []
        self.pairs = None       # a stream's check pairs (check_pairs)
        self.paused_s = 0.0     # the window's time spent on captures

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, name, fn, *args):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            out = fn(*args)
            self.sync()
        dt = time.perf_counter() - t0
        self.spans[name].append(dt)
        return out, dt

    # -- the loops ---------------------------------------------------------
    def run(self) -> dict:
        self.scene = Scene(self.cfg, self.device)
        self.mapper = make_mapper(self.cfg, self.device)
        loop = self.mix["loop"]
        getattr(self, f"_setup_{loop}")()
        self.sync()
        self.setup_s = self.setup_clock()
        self.spans = {"update": [], "test": []}
        t0 = time.perf_counter()
        getattr(self, f"_window_{loop}")(t0 + self.seconds)
        self.window_s = time.perf_counter() - t0 - self.paused_s
        self.window_spans = {k: list(v) for k, v in self.spans.items()}
        self.tr = None
        if self.traced:
            # inputs the traced stretch needs are made before it starts
            getattr(self, f"_pretrace_{loop}", lambda: None)()
            prof = trace.profiler()
            with prof:
                t1 = time.perf_counter()
                getattr(self, f"_traced_{loop}")()
                tw = time.perf_counter() - t1
            self.tr = trace.Trace(prof, tw)
        self.peak = (torch.cuda.max_memory_allocated(self.device)
                     if self.device.type == "cuda" else 0)
        del self.mapper
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.checks = self.check()
        self.check_s = time.perf_counter() - t0
        return self.result()

    # stream: one mapper fed frame by frame, queried after each frame
    def _setup_stream(self):
        self.pairs = check_pairs(self.seed, self.scene.n_frames, self.mix)
        self._episode_loop(10 ** 9, self.scene.episode(self.seed, 10 ** 9))
        self.mapper.reset()                     # warm-up: one episode

    def _episode_loop(self, episode, frames, deadline=None, window=False):
        """One episode: the map reset, then each frame's update() and
        test(). In the window, frames start until the deadline (which the
        captures' time moves on; returns False once it passed), each
        frame's latency is kept, and the frames of the check's pairs keep
        the map before and after the update."""
        m = self.mapper
        m.reset()
        for j, args in enumerate(frames):
            if window and time.perf_counter() >= deadline + self.paused_s:
                return False
            keep = window and (episode, j) in self.pairs
            t0 = time.perf_counter()
            before = snapshot(m) if keep else None
            self.paused_s += time.perf_counter() - t0
            _, tu = self._timed("update", m.update, *args)
            out, tt = self._timed("test", m.test, self.scene.grid)
            if not window:
                continue
            self.latencies.append(tu + tt)
            if keep:
                t0 = time.perf_counter()
                self.captures.append(dict(episode=episode, frame=j,
                                          nodes=snapshot(m), out=out,
                                          q=self.scene.grid, before=before,
                                          args=args))
                self.paused_s += time.perf_counter() - t0
        return True

    def _window_stream(self, deadline):
        e = 0
        while True:
            # making the episode's frames is the traffic's work, not the
            # program's: the window pauses for it
            t0 = time.perf_counter()
            frames = self.scene.episode(self.seed, e)
            self.paused_s += time.perf_counter() - t0
            if not self._episode_loop(e, frames, deadline, window=True):
                break
            e += 1
        self.items = len(self.latencies)
        self.points_per_item = len(self.scene.grid)

    def _pretrace_stream(self):
        self._trace_frames = self.scene.episode(self.seed, 10 ** 9 + 1)

    def _traced_stream(self):
        n0 = len(self.spans["update"])
        self._episode_loop(10 ** 9 + 1, self._trace_frames)
        self.traced_items = len(self.spans["update"]) - n0

    # query: a built map, queried batch after batch
    def _setup_query(self):
        m = self.mapper
        self.build_episode = 0
        for args in self.scene.episode(self.seed, self.build_episode):
            m.update(*args)
        self.map_nodes = snapshot(m)
        self.offsets = np.random.default_rng(_seed(self.seed, 5))
        for _ in range(self.mix["warmup_batches"]):
            m.test(self._batch()[0])

    def _batch(self):
        """The next batch: the query set shifted by a seeded offset within
        one grid step. Returns (points, offset)."""
        off = self.offsets.uniform(0.0, self.scene.step, self.scene.dim)
        return self._shifted(off), off

    def _shifted(self, off):
        return (self.scene.grid + off.astype(np.float32)).astype(np.float32)

    def _window_query(self, deadline):
        m = self.mapper
        keep = np.random.default_rng(_seed(self.seed, 11))
        k = self.mix["checks"]
        res = []
        while time.perf_counter() < deadline:
            q, _ = self._batch()
            out, dt = self._timed("test", m.test, q)
            self.latencies.append(dt)
            # a seeded uniform sample of the batches (reservoir)
            j = int(keep.integers(len(self.latencies)))
            if len(res) < k:
                res.append((q, out))
            elif j < k:
                res[j] = (q, out)
        self.captures = [dict(episode=self.build_episode, frame=None,
                              nodes=self.map_nodes, out=o, q=q)
                         for q, o in res]
        self.items = len(self.latencies)
        self.points_per_item = len(self.scene.grid)

    def _traced_query(self):
        self._traced_batches = []
        for _ in range(self.mix["trace_batches"]):
            q, off = self._batch()
            self._timed("test", self.mapper.test, q)
            self._traced_batches.append(off)
        self.traced_items = self.mix["trace_batches"]

    # -- the check ---------------------------------------------------------
    def check(self) -> dict:
        """Every number compared: the gaps between the program's answers
        and the reference's, the share of queries left out, and the map's
        numbers against the scene, the largest over the first
        mix["checks"] captures; in a stream, each checked frame's numbers
        against the reference's account of it, the largest over the
        frames, but the 95th percentiles of the new nodes' gaps over the
        square views of all the checked frames together. Frames are
        checked in the order of the seed's pairs that the window reached,
        past the first mix["checks"] until that pool holds
        mix["tail_pool"] nodes."""
        caps = self.captures
        if self.pairs is not None:
            at = {(c["episode"], c["frame"]): c for c in caps}
            caps = [at[p] for p in self.pairs if p in at]
        k = self.mix["checks"]
        spec = gp_spec(self.cfg)
        nums = dict(f=0.0, grad=0.0, var_f=0.0, var_grad=0.0,
                    excluded_share=0.0, off_surface_m=0.0,
                    uncovered_share=0.0, new_grad=0.0, new_noise=0.0,
                    new_grad_p95=0.0, new_noise_p95=0.0, new_spurious=0.0,
                    new_unmatched=0.0, reeval_wrong=0.0,
                    new_grad_max=0.0, new_noise_max=0.0,
                    new_grad_p95_frame=0.0, new_noise_p95_frame=0.0,
                    nodes=0, new_nodes=0, reeval_judged=0,
                    reeval_excused=0.0, reeval_ambiguous=0.0)
        self.checked = min(len(caps), k)
        self.checked_pairs, self.frames, self.new_pool = [], [], 0
        if not caps:
            return {key: np.inf for key in nums}
        for i, c in enumerate(caps):
            stream = "before" in c
            if i >= k and not (stream
                               and self.new_pool < self.mix["tail_pool"]):
                break
            got = self._answer_numbers(c, spec) if i < k else {}
            if stream:
                fr = self.scene.frame_numbers(c)
                self.frames.append(fr)
                self.checked_pairs.append((c["episode"], c["frame"]))
                self.new_pool += len(fr["square"]["noise"])
                got.update(fr)
            for key in nums:
                nums[key] = max(nums[key], got.get(key, 0.0))
        if self.frames:
            for key in ("grad", "noise"):
                gaps = np.concatenate([f["square"][key]
                                       for f in self.frames])
                nums[f"new_{key}_p95"] = float(np.quantile(gaps, 0.95)) \
                    if len(gaps) else 0.0
        return nums

    def _answer_numbers(self, c, spec) -> dict:
        """A captured test() call against the reference's answers, and
        the map it read against the scene."""
        nd = c["nodes"]
        cells = reference.Cells(spec, nd["pos"], nd["grad"], nd["val"],
                                nd["pos_sig"], nd["grad_sig"], self.device)
        rows, valid, rq, exc = reference.reference_answers(cells, c["q"])
        got = reference.compare(rows, valid, rq, exc, c["out"], spec)
        if np.asarray(c["out"]).dtype != np.dtype(self.cfg["precision"]):
            # answers in another precision than the configuration states
            # are not the configuration's
            got["f"] = np.inf
        frames = list(range(self.scene.n_frames)) if c["frame"] is None \
            else [c["frame"]]
        got.update(self.scene.map_numbers(nd["pos"], frames))
        got["nodes"] = len(nd["pos"])
        return got

    def correct(self) -> bool:
        return all(self.checks[k] <= lim for k, lim in self.limits.items())

    # -- the result ----------------------------------------------------------
    def context(self):
        tile = None
        if self.tr is not None and self.mix["loop"] == "query":
            spec = gp_spec(self.cfg)
            nd = self.map_nodes
            cells = reference.Cells(spec, nd["pos"], nd["grad"], nd["val"],
                                    nd["pos_sig"], nd["grad_sig"],
                                    self.device)
            fl = by = 0.0
            for off in self._traced_batches:
                a, b, _ = work.tile_work(cells, self._shifted(off))
                fl, by = fl + a, by + b
            tile = (fl, by)
        peaks = load_json("harness", "peaks.json")
        return SimpleNamespace(
            cell=self.cell, cfg=self.cfg, mix=self.mix,
            setup_s=self.setup_s, window_s=self.window_s, items=self.items,
            points_per_item=self.points_per_item, latencies=self.latencies,
            spans=self.window_spans, trace=self.tr,
            traced_items=getattr(self, "traced_items", 0), tile_work=tile,
            peaks=peaks, device=self.device,
            device_kind=(torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "cpu"))

    def result(self) -> dict:
        b = self.bench
        name = self.cell["name"]
        kind = "per_layer" if self.traced else "end_to_end"
        ctx = self.context()
        metrics = {}
        for m in b[kind]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(self.peak)}
        out = {"correct": self.correct(), "attempted": self.items,
               "failed": 0, "metrics": metrics, "device": dev}
        if self.tr is not None:
            dev["busy_s"] = self.tr.busy_s
            dev["window_s"] = self.tr.window_s
            out["breakdown"] = {"device_ops": self.tr.device_ops(),
                                "idle_gaps": self.tr.idle_gaps()}
        if self.pairs is not None:
            # what a stream's check read: the pairs, in the seed's order,
            # and the size of the percentiles' pool (read, not compared)
            out["checked"] = {
                "checked_pairs": [list(p) for p in self.checked_pairs],
                "listed_pairs": len(self.pairs),
                "new_pool": self.new_pool,
                "tail_pool": self.mix["tail_pool"]}
        # a number that could not be read (no call captured) prints null
        out["checks"] = {k: [float(self.checks[k]) if np.isfinite(
            self.checks[k]) else None, lim] for k, lim in self.limits.items()}
        return out
