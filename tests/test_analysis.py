"""Tests for analysis observables, exporters, and the Dormand-Prince twin."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from porousfreezethaw.analysis import (
    eps_s, freezing_point_statistic, ice_volume_fraction, series_statistics)
from porousfreezethaw.core.grid import GridGeometry
from porousfreezethaw.io import exporters
from porousfreezethaw.io.snapshots import write_snapshot
from porousfreezethaw.solvers import dopri45_solve, MersonParams, merson_init, merson_solve

from tests.test_freezing_equation import default_params


class TestObservables:
    def test_ice_fraction(self):
        p = np.zeros((4, 4, 4))
        p[:2] = 1.0
        assert ice_volume_fraction(p) == pytest.approx(0.5)

    def test_freezing_point_stat(self):
        p = np.zeros((2, 2, 2))
        u = np.full((2, 2, 2), -10.0)
        p[0, 0, 0] = 1.0
        # mean of |(p>0.5)*u| = 10/8
        assert freezing_point_statistic(u, p) == pytest.approx(10.0 / 8.0)

    def test_eps_s_single_sphere(self):
        # one r=0.1 sphere fully inside the unit box: eps_s ~ (4/3)pi r^3
        pos = np.array([[0.5, 0.5, 0.5]])
        val = eps_s(pos, r=0.1, res=100)
        assert val == pytest.approx(4 / 3 * math.pi * 0.1**3, rel=0.05)

    def test_eps_s_overlap_counts_per_sphere(self):
        # two coincident spheres double-count, like the reference's loop
        pos = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]])
        one = eps_s(pos[:1], r=0.1, res=50)
        two = eps_s(pos, r=0.1, res=50)
        assert two == pytest.approx(2 * one)

    def test_series_statistics(self, tmp_path):
        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        for snap, frac in enumerate([0.0, 0.25]):
            fields = np.zeros((3,) + geom.shape)
            fields[0] = 270.0
            fields[1, :int(8 * frac)] = 1.0
            write_snapshot(str(tmp_path / f"image.{snap:03d}.ncd"), geom, prm,
                           fields, calc_mode=0, delta=1e-3, tau=1.0,
                           t=float(snap), final_time=2.0, snapshot=snap,
                           total_snapshots=2)
        stats = series_statistics(str(tmp_path))
        assert stats["t"] == [0.0, 1.0]
        assert stats["ice_fraction"] == pytest.approx([0.0, 0.25])
        assert stats["freezing_point"][1] == pytest.approx(270.0 * 0.25)


class TestExporters:
    def test_vtk_roundtrip(self, tmp_path):
        data = np.arange(24, dtype=float).reshape(2, 3, 4)
        path = str(tmp_path / "f.vtk")
        exporters.vtk_export(path, data, comment="test field")
        assert exporters.vtk_get_grid_dim(path) == (4, 3, 2)
        np.testing.assert_allclose(exporters.vtk_import(path), data)
        head = open(path).read().splitlines()
        assert head[0].startswith("# vtk DataFile")
        assert "DATASET STRUCTURED_POINTS" in head

    def test_plain_roundtrip(self, tmp_path):
        data = np.random.RandomState(0).standard_normal((5, 3))
        path = str(tmp_path / "t.txt")
        exporters.plain_export(path, data, comment="c")
        np.testing.assert_allclose(exporters.plain_import(path), data,
                                   rtol=1e-5)

    def test_gnuplot_format(self, tmp_path):
        path = str(tmp_path / "g.dat")
        exporters.gnuplot_export(path, np.array([[1.0, 2.0], [3.0, 4.0]]))
        lines = open(path).read().splitlines()
        assert lines[0] == "0 0 1"
        assert lines[1] == "1 0 2"
        assert lines[2] == ""  # row separator

    def test_pgm_roundtrip(self, tmp_path):
        img = np.linspace(0, 1, 12).reshape(3, 4)
        path = str(tmp_path / "i.pgm")
        exporters.pgm_export(path, img, maxcolor=255)
        assert exporters.pnm_get_dim(path) == (4, 3, "P5")
        back = exporters.pnm_import(path)
        np.testing.assert_allclose(back / 255.0, img, atol=1 / 255)

    def test_ppm_roundtrip(self, tmp_path):
        r = np.ones((2, 2)) * 0.5
        g = np.zeros((2, 2))
        b = np.ones((2, 2))
        path = str(tmp_path / "i.ppm")
        exporters.ppm_export(path, r, g, b, maxcolor=255)
        back = exporters.pnm_import(path)
        assert back.shape == (2, 2, 3)
        assert back[0, 0, 2] == 255 and back[0, 0, 1] == 0

    def test_fp_precision(self, tmp_path):
        exporters.set_export_fp_precision(3)
        path = str(tmp_path / "p.txt")
        exporters.plain_export(path, np.array([[1.23456789]]))
        assert "1.23" in open(path).read()
        exporters.set_export_fp_precision(6)


class TestDopri:
    def test_exponential(self):
        f = lambda t, y: -y
        res = dopri45_solve(f, 0.0, jnp.ones((1,), jnp.float64), 1.0, 0.1,
                            rtol=1e-9, atol=1e-12)
        assert float(res.t) == pytest.approx(1.0)
        assert float(res.y[0]) == pytest.approx(math.exp(-1.0), rel=1e-8)

    def test_oscillator_tolerance_scaling(self):
        f = lambda t, y: jnp.stack([y[1], -y[0]])
        y0 = jnp.asarray([1.0, 0.0], jnp.float64)
        loose = dopri45_solve(f, 0.0, y0, 10.0, 0.1, rtol=1e-4, atol=1e-6)
        tight = dopri45_solve(f, 0.0, y0, 10.0, 0.1, rtol=1e-9, atol=1e-12)
        assert int(tight.steps) > int(loose.steps)
        assert float(tight.y[0]) == pytest.approx(math.cos(10.0), abs=1e-7)

    def test_cross_validates_merson_on_dem(self):
        """The two independent integrators must agree on a small DEM drop —
        the reference's C-vs-MATLAB redundancy check (SURVEY §4.3)."""
        from porousfreezethaw.models.dem import DEMConfig, make_dem_rhs
        cfg = DEMConfig(variant="basic", n=1)
        y0 = {"pos": jnp.asarray([[0.5, 0.5, 0.3]], jnp.float64),
              "vel": jnp.zeros((1, 3), jnp.float64)}
        rhs = make_dem_rhs(cfg)
        # to t=0.22: free fall + entry into the stiff contact layer
        res_d = dopri45_solve(rhs, 0.0, y0, 0.22, 0.01, rtol=1e-7, atol=1e-9)
        st = merson_init(y0, 0.0, 0.01)
        st, status = merson_solve(rhs, st, 0.22,
                                  MersonParams(delta=1e-6, h_min=1e-12))
        assert int(status) == 0
        np.testing.assert_allclose(np.asarray(res_d.y["pos"]),
                                   np.asarray(st.y["pos"]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(res_d.y["vel"]),
                                   np.asarray(st.y["vel"]), atol=1e-3)
