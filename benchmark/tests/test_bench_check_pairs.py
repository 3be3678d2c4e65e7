"""A stream's check reads frames that the seed alone fixes, and takes the
new nodes' 95th percentiles over a pool of them that it fills frame by
frame: what it judges does not depend on how far the window ran."""
import pytest

from conftest import TAIL_POOL, cpu_run, scratch_copy
from harness import cell

SEED = 2016970390
MIX = cell.load_json("traffic", "stream.json")


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 5])
def test_pairs_come_from_the_seed_alone(seed):
    pairs = cell.check_pairs(seed, 40, MIX)
    assert pairs == cell.check_pairs(seed, 40, MIX)
    assert pairs != cell.check_pairs(seed + 1, 40, MIX)
    assert len(pairs) == len(set(pairs)) == MIX["pairs"]
    assert pairs[0][1] == 39
    assert all(0 <= e < MIX["pair_episodes"] and 1 <= j <= 39
               for e, j in pairs)
    # a scene with fewer frames than the list asks for lists them all
    assert sorted(cell.check_pairs(seed, 3, dict(MIX, pair_episodes=2))) \
        == [(0, 1), (0, 2), (1, 1), (1, 2)]


def test_windows_of_two_lengths_check_the_same(tmp_path):
    outs = []
    for seconds in (4.0, 9.0):
        d = tmp_path / str(seconds)
        d.mkdir()
        run, out = cpu_run(d, scratch_copy(d), "tiny3d.stream", SEED,
                           seconds=seconds)
        outs.append((run.items, out["checked"], out["checks"]))
    (n0, checked0, checks0), (n1, checked1, checks1) = outs
    assert n1 > n0, "the longer window ran no more frames"
    assert checked0 == checked1
    assert checks0 == checks1


@pytest.mark.parametrize("workload", ["room2d.stream", "tiny3d.stream"])
def test_the_pool_fills_to_tail_pool(tmp_path, workload):
    run, out = cpu_run(tmp_path, scratch_copy(tmp_path), workload, SEED,
                       seconds=6.0)
    checked = out["checked"]
    assert checked["tail_pool"] == TAIL_POOL
    assert len(run.captures) == checked["listed_pairs"] == len(run.pairs)
    pools = [len(f["square"]["noise"]) for f in run.frames]
    assert checked["new_pool"] == sum(pools) >= TAIL_POOL
    assert [tuple(p) for p in checked["checked_pairs"]] == \
        run.pairs[:len(pools)]
    # a frame past the first `checks` is read only while the pool is short
    k = run.mix["checks"]
    assert len(pools) <= k or sum(pools[:-1]) < TAIL_POOL
