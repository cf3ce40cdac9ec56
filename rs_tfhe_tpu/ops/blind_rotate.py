"""Batched blind rotation: the TFHE bootstrap hot loop.

Reference: rs-tfhe trgsw.rs:198-274. The n0-step CMUX chain is inherently
sequential per ciphertext (each step consumes the previous accumulator), so —
exactly as the reference scales by batching independent ciphertexts across CPU
threads (trgsw.rs:289-305) — we batch ciphertexts on the device: a `lax.scan`
over the n0 steps where every step processes the whole [B, 2, N] accumulator
batch:

  step i:  rot   = X^{a~_i} * acc            (per-batch monomial rotation)
           diff  = rot - acc
           d     = gadget_decompose(diff)    [B, 2L, N]
           delta = d (x) BSK_i               (exact int8 limb contraction)
           acc   = acc + delta               (== CMUX(acc, rot; BSK_i))

The BSK stays in its [n0, 2L, 2, N] coefficient form (a few MB); each step
expands its row into the contraction operand on the fly (ops/poly.py).

Step implementations (config.step_impl; all bit-exact): "auto" and "xla" —
the circulant contraction above, one [B*dk, 2L*N] x [2L*N, 8N] int8 GEMM per
step; "nussbaumer" — the transform path (ops/nussbaumer.py), explicit only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config
from ..params import TORUS_BITS, TfheParams
from .decompose import gadget_decompose
from .poly import build_step_matrix, monomial_rotate, polymul_small_by_torus_multi

STEP_IMPLS = ("auto", "xla", "nussbaumer")


def check_step_impl() -> str:
    """config.step_impl, validated: a removed or misspelled value raises
    instead of silently running another path."""
    impl = config.step_impl
    if impl not in STEP_IMPLS:
        raise ValueError(
            f"unknown step_impl {impl!r} (RS_TFHE_STEP_IMPL); "
            f"expected one of {STEP_IMPLS}"
        )
    return impl


def mb_route_batch_cap(params: TfheParams) -> int:
    """Largest batch `auto` routes through the multi-bit chain when the key
    carries multi-bit material: the half-length chain halves the sequential
    steps but contracts twice the BSK entries per rotation, so it is a
    small-batch lever only. The caps (2 at L=2, 4 at L >= 3) were set on
    another accelerator and are not yet re-derived on the GPU."""
    return 4 if params.trgsw_lv1.l >= 3 else 2


def modswitch(x: jax.Array, params: TfheParams) -> jax.Array:
    """Round torus values to [0, 2N) (reference trgsw.rs:202-211)."""
    nbit = params.trgsw_lv1.nbit
    rnd = jnp.uint32(1 << (TORUS_BITS - nbit - 2))
    return ((x + rnd) >> jnp.uint32(TORUS_BITS - nbit - 1)).astype(jnp.int32)


def blind_rotate_mb(
    ct: jax.Array,
    testvec: jax.Array,
    bsk_mb: jax.Array,
    params: TfheParams,
) -> jax.Array:
    """Multi-bit (grouping factor 2) blind rotation: n0/2 external products.

    bsk_mb: uint32 [n0/2, 4, 2L, 2, N] pair-indicator TRGSWs
    (key.gen_bootstrapping_key_mb). Per group, the four entries are combined
    in the uint32 WORD domain with per-ciphertext monomial rotations —
        comb = sum_v X^(a1*v1 + a2*v2) * G_v  (encrypts X^(a1*s1 + a2*s2))
    — and ONE external product replaces the accumulator:  acc <- acc ⊡ comb.
    Halves the sequential chain (a latency lever at tiny batches); NOT a
    throughput lever — the combined operand is per ciphertext, so each step
    builds one circulant per ciphertext (under vmap). No reference analog
    (trgsw.rs:198-226 is bit-serial).
    """
    g = params.trgsw_lv1
    n0, n1 = params.n0, params.n1
    assert n0 % 2 == 0
    batch = ct.shape[0]

    b_til = (2 * n1 - modswitch(ct[:, n0], params)) % (2 * n1)  # [B]
    a_til = modswitch(ct[:, :n0], params)  # [B, n0]
    a1 = a_til[:, 0::2]  # [B, G]
    a2 = a_til[:, 1::2]

    tv = jnp.broadcast_to(testvec, (batch, 2, n1))
    acc0 = monomial_rotate(tv, b_til[:, None])

    def step(acc, xs):
        w, a1_i, a2_i = xs  # [4, 2L, 2, N], [B], [B]
        k = jnp.stack(
            [jnp.zeros_like(a1_i), a1_i, a2_i, (a1_i + a2_i) % (2 * n1)]
        )  # [4, B]
        wb = jnp.broadcast_to(w[:, None], (4, batch, 2 * g.l, 2, n1))
        rot = monomial_rotate(wb, k[:, :, None, None])
        comb = rot[0] + rot[1] + rot[2] + rot[3]  # [B, 2L, 2, N] (wraps)
        digits = gadget_decompose(acc, params)  # [B, 2L, N]
        out = jax.vmap(
            lambda dd, ww: polymul_small_by_torus_multi(
                dd, build_step_matrix(ww), params.digit_limbs, 2
            )
        )(digits, comb)
        return out, None

    acc, _ = jax.lax.scan(step, acc0, (bsk_mb, a1.T, a2.T))
    return acc


def blind_rotate(
    ct: jax.Array,
    testvec: jax.Array,
    bsk: jax.Array,
    params: TfheParams,
    bsk_mb=None,
) -> jax.Array:
    """Blind-rotate a batch of lv0 LWE ciphertexts.

    ct:      uint32 [B, n0+1]
    testvec: uint32 [2, N] (shared) or [B, 2, N] (per-ciphertext LUTs)
    bsk:     uint32 [n0, 2L, 2, N] (TRGSW coefficient polys)
    bsk_mb:  optional multi-bit pair-indicator key
             (CloudKey.generate(multibit=True)); batches up to
             mb_route_batch_cap route through the half-length grouped chain
             (blind_rotate_mb) when present
    Returns the accumulator TRLWE batch, uint32 [B, 2, N].
    """
    impl = check_step_impl()
    n0, n1 = params.n0, params.n1
    batch = ct.shape[0]

    if bsk_mb is not None and impl == "auto" and (
        batch <= mb_route_batch_cap(params)
    ):
        return blind_rotate_mb(ct, testvec, bsk_mb, params)

    b_til = (2 * n1 - modswitch(ct[:, n0], params)) % (2 * n1)  # [B]
    a_til = modswitch(ct[:, :n0], params)  # [B, n0]

    tv = jnp.broadcast_to(testvec, (batch, 2, n1))
    acc0 = monomial_rotate(tv, b_til[:, None])

    if impl == "nussbaumer":
        from .nussbaumer import check_bounds, external_product_step, prepare_bsk_step

        if not check_bounds(params):
            raise ValueError("nussbaumer step: parameter bounds not satisfied")

        def delta_fn(digits, bsk_i):
            return external_product_step(
                digits, prepare_bsk_step(bsk_i, params), params
            )
    else:

        def delta_fn(digits, bsk_i):
            mat = build_step_matrix(bsk_i)
            return polymul_small_by_torus_multi(
                digits, mat, params.digit_limbs, 2
            )

    def step(acc, xs):
        bsk_i, a_i = xs
        rot = monomial_rotate(acc, a_i[:, None])
        digits = gadget_decompose(rot - acc, params)  # [B, 2L, N]
        return acc + delta_fn(digits, bsk_i), None

    # unroll=2 lets XLA overlap step i's contraction with step i+1's operand
    # build; a value chosen on another accelerator, not yet re-derived here.
    acc, _ = jax.lax.scan(step, acc0, (bsk, a_til.T), unroll=2)
    return acc
