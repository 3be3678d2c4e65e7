"""The 2D frame's re-evaluation and new-measurement stages: the CPU path
(the plain versions, unchanged by the kernel), the packed frame the
single-card update reads back, the re-localization step count, and (on a
CUDA card only) the kernel (csrc/obsgp1d_frame.cu) against the plain
versions on the card.

The CUDA tests run on a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_obsgp1d_frame.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu_torch import GPisMap2D  # noqa: E402
from gpismap_tpu_torch.models import mapper2d as m2  # noqa: E402
from gpismap_tpu_torch.models import obsgp  # noqa: E402
from gpismap_tpu_torch.ops import obsgp1d_frame as frame_ops  # noqa: E402
from torch_frame_checks import (AGREE, G_MAX, branch_case,  # noqa: E402
                                case_args, check_frame, compare_frame,
                                plain_frame)

# ---------------------------------------------------------------------------
# CPU: the plain path, the packed frame, the step count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["reeval", "newmeas", "frame"])
def test_cpu_tensors_take_the_plain_path(stage):
    """On CPU tensors reeval_2d, newmeas_2d and frame_update_2d return the
    plain versions' outputs to the last bit and launch nothing."""
    args = case_args(branch_case(), "cpu")
    th, rg, tr, rot, pos, grad, ps, gs, valid, mp, op = args
    before = frame_ops.launches
    rw, nw = plain_frame(args)
    prep = m2.preprocess_2d(th, rg, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=G_MAX)
    if stage == "reeval":
        got, want = (m2.reeval_2d(obs, pos, grad, ps, gs, valid, tr, rot,
                                  mp, op),), (rw,)
    elif stage == "newmeas":
        got, want = (m2.newmeas_2d(obs, prep, rot, mp, op),), (nw,)
    else:
        got, want = m2.frame_update_2d(*args, g_max=G_MAX), (rw, nw)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert frame_ops.launches == before


def test_frame_kernel_refuses_cpu_tensors():
    """frame_2d takes CUDA tensors only: a CPU tensor raises before any
    build or launch."""
    th, rg, tr, rot, pos, grad, ps, gs, valid, mp, op = case_args(
        branch_case(), "cpu")
    prep = m2.preprocess_2d(th, rg, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=G_MAX)
    before = frame_ops.launches
    with pytest.raises(ValueError, match="unsupported device"):
        m2._frame_kernel(obs, (pos, grad, ps, gs, valid), m2._beams(prep),
                         tr, rot, mp, op)
    assert frame_ops.launches == before


def _room_args():
    """frame_update_2d's arguments of the second room frame, against the
    nodes the first one mapped (a CPU mapper's own update)."""
    frames = torch_scenes.room_frames(2, 181)
    m = GPisMap2D(device="cpu")
    m.update(*frames[0])
    calls = []
    orig = m2.frame_update_2d

    def keep(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    m2.frame_update_2d = keep
    try:
        m.update(*frames[1])
    finally:
        m2.frame_update_2d = orig
    (a, k), = calls
    return a, k["g_max"]


@pytest.mark.parametrize("case", ["branches", "room"])
def test_host_split_matches_plain(case):
    """The packed frame, read back and split on the host (the single-card
    update's path), gives exactly the plain versions' outputs, dtypes
    included; the device-side split gives the same views."""
    if case == "branches":
        args, g_max = case_args(branch_case(), "cpu"), G_MAX
    else:
        args, g_max = _room_args()
    rw, nw = plain_frame(args, g_max)
    buf = m2.frame_update_2d(*args, g_max=g_max, packed=True)
    k, n = args[4].shape[0], args[0].shape[0]
    assert buf.dtype == torch.float32
    assert buf.shape == (k * m2.NODE_WORDS + n * m2.BEAM_WORDS,)
    rh, nh = m2.unpack_frame_2d(buf.numpy(), k, n)
    for got, want in ((rh, rw), (nh, nw)):
        assert type(got) is type(want)
        for name, a, b in zip(want._fields, got, want):
            b = b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    rt, nt = m2.unpack_frame_2d(buf, k, n)
    assert nt.insert_ok.dtype == torch.bool and rt.steps.dtype == torch.int32
    assert torch.equal(nt.insert_ok, nw.insert_ok)
    assert torch.equal(rt.action, rw.action)


@pytest.mark.parametrize("strict", [False, True])
def test_reeval_steps_stat(strict):
    """update() reports the frame's re-localization steps: 0 on a first
    frame (no nodes), then at most 10 a node the frame re-evaluated, and
    the same count as the plain loop's on the captured nodes."""
    frames = torch_scenes.room_frames(3, 181)
    m = GPisMap2D(device="cpu", strict_reeval=strict)
    m.update(*frames[0])
    assert m.stats["reeval_steps"] == 0
    for f in frames[1:]:
        before = m.num_nodes
        m.update(*f)
        steps = m.stats["reeval_steps"]
        assert isinstance(steps, int)
        assert 0 <= steps <= m2._RELOC_ITERS * before
    assert m.stats["reeval_steps"] > 0


# ---------------------------------------------------------------------------
# the card: the kernel against the plain versions
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the frame kernel has no "
                    "CPU mode")


def episode_calls(frames, strict=False):
    """Run a card mapper over the frames and keep the arguments of every
    frame_update_2d (strict: every reeval_2d and newmeas_2d) call."""
    calls = []
    names = ("reeval_2d", "newmeas_2d") if strict else ("frame_update_2d",)
    origs = {n: getattr(m2, n) for n in names}

    def keeper(name):
        def keep(*a, **k):
            calls.append((name, a, k))
            return origs[name](*a, **k)
        return keep

    m = GPisMap2D(device="cuda", strict_reeval=strict)
    for n in names:
        setattr(m2, n, keeper(n))
    try:
        m.update_batch(frames)
    finally:
        for n, f in origs.items():
            setattr(m2, n, f)
    return m, calls


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_floor_episode():
    """Every frame of a 28-scan floor episode (1,081 beams padded to
    2,048, g_max 104, nodes padded to a power of two): the kernel's packed
    frame against the plain versions on the card."""
    _need_cuda()
    frames = torch_scenes.floor_frames(28)
    _, calls = episode_calls(frames)
    assert len(calls) == len(frames)
    for _, a, k in calls:
        got = m2.frame_update_2d(*a, g_max=k["g_max"])
        want = plain_frame(a, k["g_max"])
        check_frame(compare_frame(got, want, a[8].cpu().numpy()))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_branch_case():
    """The synthetic frame that reaches every branch: actions 0-3,
    sentinel variances, gradient-free beams; the kernel against the plain
    versions, and the device split of one launch's buffer."""
    _need_cuda()
    args = case_args(branch_case(), "cuda")
    rw, nw = want = plain_frame(args)
    acts = np.bincount(rw.action.cpu().numpy()[branch_case()[8]],
                       minlength=4)
    assert (acts > 0).all(), acts
    assert bool((nw.noise == 100.0).any())              # gradient-free
    before = frame_ops.launches
    got = m2.frame_update_2d(*args, g_max=G_MAX)
    assert frame_ops.launches == before + 1
    c = compare_frame(got, want, branch_case()[8])
    check_frame(c)
    assert c["steps_agree"] >= AGREE, c


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_in_strict_mode():
    """The strict mode's per-cell reeval_2d and the frame's newmeas_2d on
    the card against the plain versions, on the cell batches of a floor
    episode's first frames."""
    _need_cuda()
    _, calls = episode_calls(torch_scenes.floor_frames(4), strict=True)
    assert {c[0] for c in calls} == {"reeval_2d", "newmeas_2d"}
    for name, a, k in calls:
        if name == "reeval_2d":
            got = (m2.reeval_2d(*a, **k), _empty_nm())
            want = (m2.reeval_2d_reference(*a, **k), _empty_nm())
            c = compare_frame(got, want, a[5].cpu().numpy())
        else:
            got = (_empty_rv(), m2.newmeas_2d(*a, **k))
            want = (_empty_rv(), m2.newmeas_2d_reference(*a, **k))
            c = compare_frame(got, want, np.zeros(0, bool))
        check_frame(c)


def _empty_rv():
    z = torch.zeros(0)
    zi = torch.zeros(0, dtype=torch.int32)
    return m2.Reeval2D(zi, z.reshape(0, 2), z.reshape(0, 2), z, z, z, z, zi)


def _empty_nm():
    z = torch.zeros(0)
    return m2.NewMeas2D(torch.zeros(0, dtype=torch.bool), z.reshape(0, 2),
                        z.reshape(0, 2), z, z)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
def test_cuda_update_launches_the_kernel(strict):
    """One update() on the card launches the frame kernel once (strict:
    once for the beams and once per in-view cell) and reports its steps."""
    _need_cuda()
    frames = torch_scenes.floor_frames(3)
    m = GPisMap2D(device="cuda", strict_reeval=strict)
    m.update_batch(frames[:2])
    before = frame_ops.launches
    m.update(*frames[2])
    n = frame_ops.launches - before
    assert n == 1 if not strict else n >= 2
    assert 0 < m.stats["reeval_steps"] <= m2._RELOC_ITERS * m.num_nodes
