"""The kernels' division of a carry row by its maximum (``quot`` in
``tagdust_tpu_torch/engine/csrc/rowdiv.cuh``, shared by the dense kernels
and ``td_estep``).

The kernels must keep the parent kernels' bits, whose rescale is the IEEE
division ``x / d`` rounded to nearest.  ``quot`` computes the same quotient
without the compiled division's per-element range check and slow path: d
and a small x scaled by powers of two, q0 = RN(x y) with y = RN(1/dn), two
corrections with the exact remainder (Markstein), the quotient scaled back
and, when subnormal, rounded onto its grid with the remainder's sign at a
tie.  The kernel runs only on a card, so
this test runs the same sequence in exact rational arithmetic, rounding
every step to binary32 as the card does, and holds it to the correctly
rounded quotient on seeded and edge-case operands."""

from fractions import Fraction

import numpy as np
import pytest

SUB = Fraction(1, 2**149)  # the smallest subnormal


def rn(v: Fraction) -> Fraction:
    """v rounded to the nearest binary32, ties to even (no overflow here)."""
    if v == 0:
        return Fraction(0)
    sign = -1 if v < 0 else 1
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    grain = Fraction(2) ** (e - 23) if e >= -126 else SUB
    k, rem = divmod(a, grain)
    if rem * 2 > grain or (rem * 2 == grain and k % 2):
        k += 1
    return sign * k * grain


def fma(a, b, c):
    return rn(a * b + c)


def quot(x: Fraction, d: Fraction) -> Fraction:
    """The kernel's row_div(d) and quot(x) step by step."""
    P = lambda e: Fraction(2) ** e  # noqa: E731

    def expo(v):  # the binary exponent of v > 0
        e = v.numerator.bit_length() - v.denominator.bit_length()
        return e if P(e) <= v else e - 1

    sub = d < P(-126)
    dd = d * P(64) if sub else d
    kd = expo(dd) - (64 if sub else 0)
    dn = dd / P(expo(dd))
    y = rn(1 / dn)
    if x == 0:
        return x
    small = x < P(-36)
    xs = x * P(64) if small else x
    q0 = rn(xs * y)
    r0 = fma(-dn, q0, xs)
    q1 = fma(y, r0, q0)
    r1 = fma(-dn, q1, xs)
    q = fma(y, r1, q1)
    n = -kd - (64 if small else 0)
    e = expo(q) + n
    if e >= -126:
        return q * P(n)
    if e < -151:
        return Fraction(0)
    t = q * P(n + 149)
    m = t.numerator // t.denominator
    fr = t - m
    if fr > Fraction(1, 2):
        m += 1
    elif fr == Fraction(1, 2):
        r = fma(-dn, q, xs)
        if r > 0 or (r == 0 and m % 2):
            m += 1
    return m * SUB


def f32(v) -> Fraction:
    return Fraction(float(np.float32(v)))


def f32_of(rng, lo: int, hi: int) -> Fraction:
    """A seeded binary32 of exponent lo..hi (below -126: a subnormal),
    its significand random or all ones one time in ten."""
    e = int(rng.integers(lo, hi + 1))
    if e < -126:
        return Fraction(int(rng.integers(1, 1 << 23))) * SUB
    sig = (1 << 24) - 1 if rng.random() < 0.1 else int(rng.integers(1 << 23, 1 << 24))
    return Fraction(sig) * Fraction(2) ** (e - 23)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_division_is_the_correctly_rounded_quotient(seed):
    """Normal, subnormal and tiny quotients; divisors from subnormal up."""
    rng = np.random.default_rng(seed)
    for _ in range(1500):
        x, d = f32_of(rng, -150, 24), f32_of(rng, -150, 30)
        assert quot(x, d) == rn(x / d), (x, d)


def test_row_division_edge_cases():
    one = Fraction(1)
    cases = [(Fraction(0), one), (one, one), (f32(0.3), f32(0.3)),
             (f32(1e-38), f32(0.7)), (SUB, f32(0.5)), (SUB, f32(3.0)),
             (f32(2.0) ** -36, f32(0.999)), (f32(1.17549435e-38), f32(1.5)),
             (f32(5.0), f32(3.0)), (f32(1e-30), f32(2.0 ** -40))]
    # ties on the subnormal grid: x / d exactly half way between two
    # subnormals, and a hair above and below it
    cases += [(3 * SUB, Fraction(2)), (5 * SUB, Fraction(2)), (7 * SUB * 4, Fraction(8)),
              (rn(Fraction(3 * 2**20 + 1, 2**20) * SUB), Fraction(2))]
    for x, d in cases:
        assert quot(x, d) == rn(x / d), (x, d)
