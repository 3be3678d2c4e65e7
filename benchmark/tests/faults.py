"""Faults planted in the program's timed path, for the tests that see the
check come out not correct and for the readings that set the upper end
of each limit. Each is a context manager that patches the program's
classes and restores them.

  unchanged     update() returns with the map as it was
  half_queries  test() answers the first half of its queries; the rest
                read as unmapped
  one_answer    test() alters the f of its surest answer by 0.01
  new_normals   the frame's new nodes get their normals' x part + 0.2
  new_noise     the frame's new nodes get twice their noises
  new_noise_late  the same, three times their noises, but only on an
                episode's frames after its 10th
  new_ungated   every eighth beam or pixel of a frame inserts a node,
                the observation GP's verdict ignored
  new_shifted   the frame's new nodes move two cell sizes along x
  reeval_skipped  the re-evaluation's actions are never applied: the
                nodes the frame sees keep their old estimates
  reeval_shifted  the nodes the re-evaluation moves land 1 mm off their
                fused position, along x

The exchange between chips is not among them: every cell runs on one
chip.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patch(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _newmeas(change):
    from gpismap_tpu_torch import api
    real = api._MapperBase._apply_newmeas

    def altered(self, nm):
        return real(self, change(self, nm))

    return _patch(api._MapperBase, "_apply_newmeas", altered)


@contextlib.contextmanager
def plant(fault: str):
    from gpismap_tpu_torch import api, api3d
    if fault == "unchanged":
        with _patch(api.GPisMap2D, "update", lambda self, *a, **k: None), \
                _patch(api3d.GPisMap3D, "update",
                       lambda self, *a, **k: None):
            yield
        return
    if fault in ("half_queries", "one_answer"):
        real = api._MapperBase.test

        def test(self, x):
            out = real(self, x)
            if fault == "half_queries":
                n = len(out) // 2
                out[n:] = 0.0
                out[n:, 1 + self.dim] = 1.0 + self.p.map_noise_param
            else:
                out[int(np.argmin(out[:, 1 + self.dim])), 0] += 0.01
            return out

        with _patch(api._MapperBase, "test", test):
            yield
        return

    def normals(self, nm):
        g = nm.grad.copy()
        g[:, 0] += 0.2
        return nm._replace(grad=g)

    def noise(self, nm):
        return nm._replace(noise=2.0 * nm.noise,
                           grad_noise=2.0 * nm.grad_noise)

    def noise_late(self, nm):
        # self.frame counts the frames since the map's reset, this one not
        # yet: 10 is the 11th
        if self.frame < 10:
            return nm
        return nm._replace(noise=3.0 * nm.noise,
                           grad_noise=3.0 * nm.grad_noise)

    def ungated(self, nm):
        ok = nm.insert_ok.copy()
        ok[::8] = True
        return nm._replace(insert_ok=ok)

    def shifted(self, nm):
        p = nm.pos.copy()
        p[:, 0] += 2.0 * self.cell_size
        return nm._replace(pos=p)

    if fault.startswith("reeval_"):
        real = api._MapperBase._apply_reeval

        def apply(self, node_ids, rv):
            if fault == "reeval_skipped":
                return None
            p = rv.pos.copy()
            p[:, 0] += 1e-3
            return real(self, node_ids, rv._replace(pos=p))

        with _patch(api._MapperBase, "_apply_reeval", apply):
            yield
        return

    change = dict(new_normals=normals, new_noise=noise,
                  new_noise_late=noise_late, new_ungated=ungated,
                  new_shifted=shifted)[fault]
    with _newmeas(change):
        yield


FAULTS = ("unchanged", "half_queries", "one_answer", "new_normals",
          "new_noise", "new_noise_late", "new_ungated", "new_shifted",
          "reeval_skipped", "reeval_shifted")
