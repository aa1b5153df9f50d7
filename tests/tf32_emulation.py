"""The TF32 arithmetic of the port's Hopper kernels, emulated with numpy on
float32 bits, for the CPU tests of K9's float32 kernel
(``test_torch_attention.py``), K8's (``test_torch_spmm.py``) and K2's
(``test_torch_sketch.py``).

3xTF32: each operand x is split into big = rna(x) and small = rna(x - big),
both TF32 (10 explicit mantissa bits, rounded to nearest with ties away from
zero, as ``cvt.rna.tf32.f32`` and the kernels' integer form both round),
and a product becomes three TF32 products into one float32 accumulator,
the small terms first: a_s b_b + a_b b_s + a_b b_b. A product of two TF32
values is exact in float32; the dropped term a_s b_s is 2^-22 of the
product. One-pass TF32, rna(a) rna(b), keeps about three decimal digits.
"""

import numpy as np


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on float32 bits: to 10 explicit mantissa bits,
    to nearest with ties away from zero (the 13 low bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x):
    """x = big + small, each TF32, as the kernels split their operands."""
    x = np.asarray(x, np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a, b):
    """a @ b as three TF32 products into one float32 accumulator, the small
    terms first: a_s b_b + a_b b_s + a_b b_b (products of TF32 values are
    exact in float32)."""
    ab, a_s = tf32_split(a)
    bb, b_s = tf32_split(b)
    acc = a_s @ bb
    acc = acc + ab @ b_s
    return acc + ab @ bb


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def _steps(k: int, step: int):
    return [slice(k0, k0 + step) for k0 in range(0, k, step)]


def mm_3xtf32_passes(a, b, step=8):
    """a (..., M, K) @ b (..., K, N) as K8's kernel orders it: three passes
    over K in steps of ``step`` into one float32 accumulator, all the a_s b_b
    steps, then the a_b b_s steps, then the a_b b_b steps."""
    ab, a_s = tf32_split(a)
    bb, b_s = tf32_split(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for x, y in ((a_s, bb), (ab, b_s), (ab, bb)):
        for k in _steps(a.shape[-1], step):
            acc = acc + x[..., k] @ y[..., k, :]
    return acc


def mm_3xtf32_stepwise(a, b, step=8, acc=None):
    """a @ b as K2's kernel orders it: at each step of ``step`` along K the
    three products, the small terms first, into the float32 accumulator
    ``acc`` (zeros if None)."""
    ab, a_s = tf32_split(a)
    bb, b_s = tf32_split(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    for k in _steps(a.shape[-1], step):
        acc = acc + a_s[..., k] @ bb[..., k, :]
        acc = acc + ab[..., k] @ b_s[..., k, :]
        acc = acc + ab[..., k] @ bb[..., k, :]
    return acc


def mm_1xtf32_steps(a, b, step=8, acc=None):
    """a @ b in one TF32 pass, in steps of ``step`` along K."""
    at, bt = tf32_rna(a), tf32_rna(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    for k in _steps(a.shape[-1], step):
        acc = acc + at[..., k] @ bt[..., k, :]
    return acc
