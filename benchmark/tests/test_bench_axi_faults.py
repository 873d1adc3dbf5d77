"""A whole run of ``axi250k.sweep`` on the CPU at ~4,000 nodes (the look
for a card skipped), once sound and once with a fault of the
axisymmetric element math planted in the program, through the
harness's own window and judged sample: the sound run comes out
correct, each broken one not.

Faults, each one this path can have:
- ``mz_at_R``: the B_r^2 term taken at the arithmetic radius R instead
  of the log-mean radius R_hat;
- ``axis_pins_misplaced``: the zero pins meant for the axis put on the
  nodes of the elements that touch it (the axis itself left free);
- ``no_loop_factor``: the source J without its loop factor 2 pi r (the
  model's 2R in its scaled units);
- ``minus_J``: the coil driven at -J.

Dropping the on-axis pins alone is no fault of the answer: the flux
2 pi r A is 0 on the axis whatever A is there, and the element
matrices' rows and columns of an on-axis node are 0 but for the
conditioning diagonal, so the other nodes' A does not move. The last
test holds that.
"""

import time

import numpy as np
import pytest

from benchmark import run

CELL = "axi250k.sweep"
SMALL = {"area_scale": 1.0}


def _run(seconds=3.0):
    return run.run_cell(CELL, 2 ** 31 + 77, seconds, False, device="cpu",
                        hbm_bytes=2e9, override=SMALL,
                        config_override={"regime": None},
                        t0=time.perf_counter())[0]


def _mz_at_R(monkeypatch):
    from xfemm_tpu_torch.ops import assembly
    real = assembly.axi_geometry

    def axi_geometry(xy, tris, axis_tol=1e-6):
        geom = real(xy, tris, axis_tol)
        return geom._replace(R_hat=geom.R)

    monkeypatch.setattr(assembly, "axi_geometry", axi_geometry)


def _packed(monkeypatch, change):
    from xfemm_tpu_torch.models import axisymmetric
    real = axisymmetric.pack

    def pack(problem, mesh):
        pk = real(problem, mesh)
        change(pk)
        return pk

    monkeypatch.setattr(axisymmetric, "pack", pack)


def _on_axis(pk):
    return np.abs(pk.xy[:, 0]) < 1e-6


def _axis_pins_misplaced(monkeypatch):
    def change(pk):
        axis = _on_axis(pk)
        ring = np.zeros_like(axis)
        ring[pk.tris[axis[pk.tris].any(axis=1)]] = True
        ring &= ~axis
        pk.fixed_mask[pk.ridx[axis]] = False
        pk.fixed_mask[pk.ridx[ring]] = True
        pk.fixed_vals[pk.ridx[ring]] = 0.0

    _packed(monkeypatch, change)


def _no_loop_factor(monkeypatch):
    def change(pk):
        R = pk.xy[pk.tris, 0].mean(axis=1)
        pk.Jre = pk.Jre / (2.0 * R)

    _packed(monkeypatch, change)


def _minus_J(monkeypatch):
    def change(pk):
        pk.Jre = -pk.Jre

    _packed(monkeypatch, change)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["checks"]["gap"]["value"] > 0.0


@pytest.mark.parametrize("fault", [_mz_at_R, _axis_pins_misplaced,
                                   _no_loop_factor, _minus_J],
                         ids=["mz_at_R", "axis_pins_misplaced",
                              "no_loop_factor", "minus_J"])
def test_broken_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert out["attempted"] >= 1
    assert not out["correct"], out["checks"]


def test_dropped_axis_pins_change_no_answer(monkeypatch):
    """The program with its on-axis pins dropped, and with them the
    conditioning diagonal of the on-axis corners, gives the sound
    answer bit for bit."""
    from benchmark import spec
    from xfemm_tpu_torch import models
    from xfemm_tpu_torch.mesh import mesher
    from xfemm_tpu_torch.ops import assembly

    bench = spec.load_benchmark()
    config = spec.config(bench, "axi250k")
    mod = spec.problem(config["problem"])
    params = dict(config["params"], **SMALL)
    mesh = mesher.mesh_problem(mod.build(params))

    def solve():
        sol = models.solve(mod.build(params), mesh, device="cpu",
                           hbm_bytes=2e9)
        return mod.answer(sol)

    sound = solve()

    def change(pk):
        pk.fixed_mask[pk.ridx[_on_axis(pk)]] = False

    _packed(monkeypatch, change)
    real = assembly.axi_curl_matrices

    def no_diagonal(geom, axis_tol=1e-6):
        Mx, My, Mxy = real(geom, axis_tol)
        on = np.asarray(geom.rn) < axis_tol
        Mx = Mx.copy()
        for j in range(3):
            Mx[on[:, j], j, j] = 0.0
        return Mx, My, Mxy

    assert np.array_equal(solve(), sound)
    monkeypatch.setattr(assembly, "axi_curl_matrices", no_diagonal)
    assert np.array_equal(solve(), sound)
