"""Multi-value programmable bootstrapping: one blind rotation, many LUTs.

Test-vector factoring in the style of Carpov-Izabachène-Mollimard (CT-RSA
2019): over Z[X]/(X^N + 1) the all-ones polynomial u = 1 + X + ... + X^{N-1}
satisfies (1 - X) * u = 1 - X^N = 2, so any test vector TV whose adjacent
coefficient differences share an even divisor 2c factors EXACTLY as

    TV = (c * u) * w,      w = (1 - X) * TV / (2c)   (integer coefficients).

One blind rotation with the shared accumulator TV0 = c * u followed by a
per-function multiply of the rotated TRLWE by the small integer polynomial
w_k reproduces, bit-for-bit, the PLAINTEXT of a dedicated rotation with
TV_k — X^{-phase} * TV0 * w_k = X^{-phase} * TV_k — while the k rotations
collapse into one. Only the noise differs: the accumulator noise is
multiplied by ||w_k||_2 (w_k is sparse: nonzero only at the LUT's bucket
boundaries, so the norm is the RMS of the LUT's value jumps).

Why this is nearly free HERE and ruinous in reference-style designs: this
implementation's blind-rotation output noise (utils.noise.estimate:
sqrt(var_br) ~ 1.1e-5 at SECURITY_128_BIT_RADIX) sits 20-100x BELOW the
key-switch (3.9e-4) and mod-switch (2.0e-3) floors, because the centered
gadget decomposition + exact integer polynomial products leave no FFT
rounding and no decomposition-bias ramp (NOTES-PERF.md in git history). Multiplying the
smallest term of the budget by ||w|| <= ~22 moves the radix decision
margins by under 2% (utils.noise.lut_margin(..., mv_norm=...)), so every
duplicated-testvector pipeline in models/arithmetic.py (sum+carry,
trichotomy e3+e1, eq/gt/lt triples) can run at one rotation per input.

The reference has no analogue (one test vector per bootstrap,
bootstrap/lut.rs:49-65): the rotation is the 700-step contraction scan,
while the w_k multiplies are a handful of static
rolls and elementwise uint32 multiply-adds that XLA fuses.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..key import CloudKey
from ..ops.blind_rotate import blind_rotate
from ..ops.extract import sample_extract
from ..ops.keyswitch import identity_key_switch

_TWO32 = 1 << 32


@dataclasses.dataclass(frozen=True)
class MultiValueLuts:
    """A factored family of test vectors sharing one blind rotation.

    tv0:    uint32 [2, N] trivial TRLWE of the common accumulator c * u.
    terms:  per function k, a tuple of (position, coefficient) pairs — the
            nonzero entries of w_k (coefficient already reduced mod 2^32).
            Static Python ints so jitted consumers unroll them.
    norms:  ||w_k||_2 — feed to utils.noise.lut_margin(mv_norm=...).
    """

    tv0: jax.Array
    terms: tuple[tuple[tuple[int, int], ...], ...]
    norms: tuple[float, ...]

    @property
    def n_luts(self) -> int:
        return len(self.terms)


def factor_test_vectors(polys) -> MultiValueLuts:
    """Factor a family of trivial test vectors through a common c * u.

    polys: sequence of uint32 [2, N] trivial TRLWEs (a-row zero, as built by
    lut.Generator / CloudKey.testvec). Raises ValueError if the family's
    common difference gcd is odd (then no integer factoring through c * u
    exists — fall back to per-function bootstraps).
    """
    mats = [np.asarray(jax.device_get(p)).astype(np.uint32) for p in polys]
    if not mats:
        raise ValueError("factor_test_vectors needs at least one test vector")
    n = mats[0].shape[-1]
    diffs = []
    g = 0
    for m in mats:
        if m.shape != (2, n):
            raise ValueError(f"test vector shape {m.shape} != (2, {n})")
        if m[0].any():
            raise ValueError("multi-value factoring needs trivial test "
                             "vectors (zero mask row)")
        tv = m[1].astype(np.int64)
        d = np.empty(n, np.int64)
        d[1:] = tv[1:] - tv[:-1]
        d[0] = tv[0] + tv[-1]  # negacyclic wrap: (1 - X) * TV coefficient 0
        d = ((d + (1 << 31)) % _TWO32) - (1 << 31)  # centered mod 2^32
        diffs.append(d)
        nz = np.abs(d[d != 0])
        g = int(np.gcd(g, int(np.gcd.reduce(nz)))) if nz.size else g
    if g == 0:
        raise ValueError("all test vectors are constant; nothing to factor")
    if g % 2:
        raise ValueError(
            f"common difference gcd {g} is odd: (1-X)*TV/2c is not integer")
    c = g // 2
    terms = []
    norms = []
    for d in diffs:
        w = d // g
        pos = np.nonzero(w)[0]
        terms.append(tuple(
            (int(p), int(w[p] % _TWO32)) for p in pos))
        norms.append(float(math.sqrt(float((w.astype(np.float64) ** 2).sum()))))
    tv0 = np.stack([np.zeros(n, np.uint32),
                    np.full(n, np.uint32(c), np.uint32)])
    return MultiValueLuts(tv0=jnp.asarray(tv0), terms=tuple(terms),
                          norms=tuple(norms))


def _mul_sparse(acc: jax.Array, terms) -> jax.Array:
    """acc * w for sparse integer w: uint32 [..., 2, N] -> same shape.

    Each (pos, coeff) contributes coeff * X^pos * acc; X^pos is a static
    negacyclic roll (wrapped head negated mod 2^32). Exact mod 2^32.
    """
    n = acc.shape[-1]
    out = None
    for pos, coeff in terms:
        if pos == 0:
            shifted = acc
        else:
            rolled = jnp.roll(acc, pos, axis=-1)
            head = jnp.uint32(0) - rolled[..., :pos]
            shifted = jnp.concatenate([head, rolled[..., pos:]], axis=-1)
        term = shifted * jnp.uint32(coeff)
        out = term if out is None else out + term
    if out is None:  # w == 0: the zero polynomial
        out = jnp.zeros_like(acc)
    assert out.shape[-1] == n
    return out


@partial(jax.jit, static_argnames=("terms", "impl"))
def _mv_pipeline(flat, tv0, ck: CloudKey, terms, impl: str = "auto"):
    # `impl` keys the jit cache on config.step_impl (read at trace time
    # inside blind_rotate — CLAUDE.md invariant, see gates._gate2).
    del impl
    acc = blind_rotate(flat, tv0, ck.bsk, ck.params)
    accs = jnp.stack([_mul_sparse(acc, t) for t in terms], axis=1)
    lv1 = sample_extract(accs)  # [B, K, N+1]
    return identity_key_switch(lv1, ck.ksk_limbs, ck.params)


def multi_value_bootstrap(ct: jax.Array, mv: MultiValueLuts,
                          ck: CloudKey) -> jax.Array:
    """K LUT outputs from ONE blind rotation per input ciphertext.

    ct: uint32 [..., n0+1]  ->  uint32 [..., K, n0+1], where output k
    decodes exactly as `bootstrap_with_testvec(ct, polys[k], ck)` would
    (same plaintext; accumulator noise scaled by mv.norms[k]).
    """
    lead = ct.shape[:-1]
    flat = ct.reshape(-1, ct.shape[-1])
    out = _mv_pipeline(flat, mv.tv0, ck, mv.terms, config.step_impl)
    return out.reshape(*lead, mv.n_luts, out.shape[-1])
