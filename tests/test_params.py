"""Tests for the Params file interpreter (reference: modules/pparser, cparser)."""

import os

import numpy as np
import pytest

from porousfreezethaw.config.params import (
    ParamError, batch_iterations, loop_suffix, parse_param_file)
from porousfreezethaw.config.evsubst import ev_subst


GOLDEN_GRADP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden", "Params-LR-GradP")


def _load_reference_params():
    with open(GOLDEN_GRADP) as f:
        return f.read()


class TestEvSubst:
    def test_basic(self):
        env = {"OUTPUT": "/tmp/out"}
        assert ev_subst("$OUTPUT/intertrack.log", env) == "/tmp/out/intertrack.log"
        assert ev_subst("${OUTPUT}/x", env) == "/tmp/out/x"
        assert ev_subst("$MISSING/x", {}) == "/x"

    def test_single_quotes_protect(self):
        env = {"A": "val"}
        assert ev_subst("'$A'/x", env) == "$A/x"
        assert ev_subst("$A'$A'", env) == "val$A"


class TestParseBasics:
    def test_name_expression_lines(self):
        pf = parse_param_file("a 2\nb a*3\nc b max 10\n")
        assert pf.vars == {"a": 2.0, "b": 6.0, "c": 10.0}

    def test_comments_and_blank(self):
        pf = parse_param_file("# full comment\n\na 1 # trailing\n")
        assert pf.vars == {"a": 1.0}

    def test_set_options(self):
        pf = parse_param_file(
            'set logfile = $OUTPUT/x.log\n'
            'set out_file = $OUTPUT/image out_file_suffix = .ncd\n'
            'set comment="Testing run"\n'
            'set skip_icond continue_series\n',
            env={"OUTPUT": "/tmp/o"})
        assert pf.setting("logfile") == "/tmp/o/x.log"
        assert pf.setting("out_file") == "/tmp/o/image"
        assert pf.setting("out_file_suffix") == ".ncd"
        assert pf.setting("comment") == "Testing run"
        assert pf.flag("skip_icond") and pf.flag("continue_series")

    def test_icond_formulas(self):
        pf = parse_param_file('icond u = "293.15"\nicond p = "z>0.5 and x<1"\n')
        assert pf.icond_formulas["u"] == "293.15"
        assert pf.icond_formulas["p"] == "z>0.5 and x<1"

    def test_grid_mode(self):
        assert parse_param_file("").grid_io_mode == "inner"
        assert parse_param_file("grid full\n").grid_io_mode == "full"
        with pytest.raises(ParamError):
            parse_param_file("grid sideways\n")

    def test_break(self):
        pf = parse_param_file("a 1\nbreak\nb 2\n")
        assert pf.broke and "b" not in pf.vars

    def test_continue_if(self):
        pf = parse_param_file("continue_if i1 < 3\na 1\n", loop_vars={"i1": 2})
        assert pf.skipped and "a" not in pf.vars
        pf = parse_param_file("continue_if i1 < 3\na 1\n", loop_vars={"i1": 3})
        assert not pf.skipped and pf.vars["a"] == 1.0

    def test_loop_vars_usable(self):
        pf = parse_param_file("a i1*10\n", loop_vars={"i1": 4, "loopIter": 1})
        assert pf.vars["a"] == 40.0

    def test_slice_commands_skipped(self):
        pf = parse_param_file(
            "slice_output\nslice_along z\nset slice_colormap = hot\na 1\n")
        assert pf.vars["a"] == 1.0

    def test_mnemonic(self):
        pf = parse_param_file("mnemonic 1: alpha beta gamma\n")
        assert pf.mnemonics[1] == ["alpha", "beta", "gamma"]


class TestReferenceParams:
    """Interpret the reference's shipped LR GradP case
    (tests/golden/Params-LR-GradP, from Cases-LR.tgz) and check the
    derived values against the documented LR case (SURVEY §2.5,
    BASELINE.md)."""

    def test_full_parse(self):
        pf = parse_param_file(_load_reference_params(), env={"OUTPUT": "/tmp/o"})
        v = pf.vars
        assert v["hours"] == 3600.0
        assert (v["L1"], v["L2"], v["L3"]) == (0.03, 0.03, 0.06)
        # grid_nodes=100 => 50 x 50 x 100 cells
        assert int(v["n1"]) == 50 and int(v["n2"]) == 50 and int(v["n3"]) == 100
        assert v["final_time"] == 36000.0
        assert v["phase_switch_time"] == 18000.0
        assert v["top_temp1"] == pytest.approx(248.15)
        assert v["top_temp2"] == pytest.approx(293.15)
        assert v["delta"] == pytest.approx(1e-3)
        assert v["tau_min"] == pytest.approx(1e-6)
        assert v["calc_mode"] == 0
        assert v["saved_files"] == 100
        # derived geometry parameters (this case: beads_scaling L1,
        # xi_gl L3/300; the later definition of ball_radius wins)
        assert v["beads_scaling"] == pytest.approx(0.03)
        assert v["ball_radius"] == pytest.approx(0.1 * 0.03)
        assert v["xi"] == pytest.approx(0.06 / 100)
        assert v["xi_gl"] == pytest.approx(0.06 / 300)
        assert v["alpha"] == pytest.approx(997 * 4.18e3)
        # settings & iconds
        assert pf.setting("out_file") == "/tmp/o/image"
        assert pf.setting("out_file_suffix") == ".ncd"
        assert "u" in pf.icond_formulas and "p" in pf.icond_formulas
        assert "gl" in pf.icond_formulas

    def test_icond_u_evaluates(self):
        from porousfreezethaw.config.expression import Expression
        pf = parse_param_file(_load_reference_params(), env={})
        expr = Expression(pf.icond_formulas["u"])
        assert expr.evaluate({}) == pytest.approx(293.15)


class TestBatch:
    def test_iterations_odometer(self):
        seq = list(batch_iterations([2, 3]))
        assert seq[0] == (1, [1, 1])
        assert seq[1] == (2, [1, 2])
        assert seq[2] == (3, [1, 3])
        assert seq[3] == (4, [2, 1])
        assert len(seq) == 6

    def test_no_loops(self):
        assert list(batch_iterations([])) == [(1, [])]

    def test_suffix(self):
        assert loop_suffix([1, 12], [2, 12], {}) == "_01_12"
        assert loop_suffix([2], [3], {1: ["soft", "med", "hard"]}) == "_med"
        assert loop_suffix([3], [3], {1: ["soft"]}) == "_3"
