"""Tests for the Params expression language (reference: libsource/exprsion)."""

import math

import numpy as np
import pytest

from porousfreezethaw.config.expression import (
    Evaluator, Expression, ExpressionError)


def ev(src, **env):
    return Expression(src).evaluate(env)


class TestBasics:
    def test_arithmetic(self):
        assert ev("4*(5+2)") == 28
        assert ev("1+2*3") == 7
        assert ev("10/4") == 2.5
        assert ev("2^10") == 1024
        assert ev("-2^2") == -4  # unary minus (prio 16) looser than ^ (14)

    def test_number_formats(self):
        # the reference lexer keeps an exponent sign inside number tokens
        assert ev("1e-3") == pytest.approx(1e-3)
        assert ev("4.18e3") == pytest.approx(4180.0)
        assert ev("1e-3 - 1") == pytest.approx(-0.999)
        assert ev(".5") == 0.5

    def test_constants(self):
        assert ev("pi") == pytest.approx(math.pi)
        assert ev("e") == pytest.approx(math.e)

    def test_functions(self):
        assert ev("sin 0") == 0
        assert ev("cos 0") == 1
        assert ev("sqrt 16") == 4
        assert ev("ln e") == pytest.approx(1.0)
        assert ev("log 100") == pytest.approx(2.0)  # log is base 10
        assert ev("exp 1") == pytest.approx(math.e)
        assert ev("pow10 3") == 1000
        assert ev("abs -4") == 4
        assert ev("int 2.7") == 2
        assert ev("int -2.7") == -2  # truncation toward zero (exp_all.cc:115)
        assert ev("floor -2.5") == -3
        assert ev("ceil 2.1") == 3
        assert ev("sgn -3") == -1

    def test_function_precedence(self):
        # '^' (14) binds tighter than prefix functions (16):
        assert ev("sin 0 ^ 2") == pytest.approx(math.sin(0.0))
        assert ev("sqrt 4 ^ 2") == pytest.approx(4.0)  # sqrt(4^2)
        # '*' (20) is looser: (sin pi) * 2
        assert ev("cos 0 * 2") == pytest.approx(2.0)

    def test_root_and_combinatorics(self):
        assert ev("3 root 27") == pytest.approx(3.0)  # y^(1/x)
        assert ev("5 C 2") == 10
        assert ev("5 P 2") == 20
        assert ev("4 !") == 24

    def test_max_min_infix(self):
        # Params uses infix: "L1 max L2 max L3" (Params:140)
        assert ev("2 max 5") == 5
        assert ev("2 min 5") == 2
        assert ev("1 max 2 max 3") == 3
        assert ev("0.03 max 0.03 max 0.06") == 0.06

    def test_comparisons_and_logic(self):
        assert ev("1 < 2") == 1
        assert ev("2 < 1") == 0
        assert ev("2 > 1") == 1
        assert ev("2 = 2") == 1
        assert ev("1 and 1") == 1
        assert ev("1 and 0") == 0
        assert ev("0 or 2") == 1
        assert ev("not 0") == 1
        assert ev("not 7") == 0

    def test_ternary(self):
        assert ev("1 ? 10 : 20") == 10
        assert ev("0 ? 10 : 20") == 20

    def test_domain_errors_yield_zero(self):
        # the reference evaluator stores an error and returns 0
        assert ev("sqrt -1") == 0
        assert ev("ln 0") == 0
        assert ev("log -5") == 0
        assert ev("0 root 8") == 0
        assert ev("1/0") == 0

    def test_variables(self):
        assert ev("a*b", a=3, b=4) == 12
        with pytest.raises(ExpressionError):
            ev("undefined_name + 1")

    def test_syntax_errors(self):
        for bad in ["", "1 +", "(1+2))", "* 3", "1 2 3 $"]:
            with pytest.raises(ExpressionError):
                ev(bad)

    def test_eof_closes_open_parens(self):
        # end of expression closes all open parentheses
        # (exp_all.cc:352-354); the shipped LR Params gl icond needs it
        assert ev("(1+2") == 3.0
        assert ev("2*(3+(4") == 14.0
        assert ev("0.5*(1.0 + tanh(0.5/xi_gl*(z-0.055))",
                  xi_gl=0.06 / 300, z=0.055) == 0.5


class TestVectorized:
    def test_array_broadcast(self):
        x = np.linspace(0, 1, 11)
        res = ev("x^2 + 1", x=x)
        np.testing.assert_allclose(res, x**2 + 1)

    def test_icond_p_formula(self):
        # the shipped Params ice-cap initial condition (Params:11)
        expr = Expression(
            'z>0.052 and z<0.058 and ((x-L1/2)^2+(y-L2/2)^2 < (L1/3)^2)')
        assert expr.names == {"z", "x", "y", "L1", "L2"}
        z = np.array([0.050, 0.055, 0.055, 0.060])
        x = np.array([0.015, 0.015, 0.029, 0.015])
        y = np.full(4, 0.015)
        res = expr.evaluate(dict(z=z, x=x, y=y, L1=0.03, L2=0.03))
        np.testing.assert_array_equal(res, [0.0, 1.0, 0.0, 0.0])

    def test_icond_gl_formula(self):
        # glass-walls formula from Params:21 (chained infix max over tanh)
        expr = Expression(
            "(0.5*(1.0 + tanh(0.5/xi_gl*(z-0.055)))) max "
            "(0.5*(1.0 + tanh(0.5/xi_gl*(beads_offset_z-z))))")
        z = np.array([0.0, 0.03, 0.06])
        res = expr.evaluate(dict(z=z, xi_gl=0.06 / 500, beads_offset_z=0.0015))
        expected = np.maximum(
            0.5 * (1 + np.tanh(0.5 / (0.06 / 500) * (z - 0.055))),
            0.5 * (1 + np.tanh(0.5 / (0.06 / 500) * (0.0015 - z))))
        np.testing.assert_allclose(res, expected)

    def test_ternary_vectorized(self):
        x = np.array([-1.0, 0.5, 2.0])
        np.testing.assert_allclose(
            ev("x > 0 ? x : 0 - x", x=x), np.abs(x))


class TestEvaluator:
    def test_define_and_eval(self):
        e = Evaluator()
        e.define("hours", 3600.0)
        assert e.eval("5*hours") == 18000
        e.define("L1", 0.03)
        e.define("grid_nodes", 100.0)
        mult = e.eval("grid_nodes / (L1 max 0.03 max 0.06)")
        assert mult == pytest.approx(100 / 0.06)

    def test_parse_then_evaluate(self):
        e = Evaluator()
        e.parse("q*2")
        e.define("q", 21.0)
        assert e.evaluate() == 42

    def test_reset(self):
        e = Evaluator()
        e.define("a", 1.0)
        e.reset()
        with pytest.raises(ExpressionError):
            e.eval("a")
