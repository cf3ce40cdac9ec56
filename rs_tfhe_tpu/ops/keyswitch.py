"""Digit-decomposition key switching as a one-hot int8 contraction.

The reference (trgsw.rs:332-360, proxy_reenc.rs:468-509) performs
data-dependent gathers into a large table of LWE rows and subtracts the
selected rows. Instead we build the one-hot selection tensor of the
base-2^basebit digits and contract it against the limb-split key table with
a single exact int8 matmul — the gather becomes tensor-core work.

Row k=0 of each (i, j) block is all-zero (the reference skips k=0,
key.rs:109-111), so selecting it subtracts nothing — no masking needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..params import TORUS_BITS, TfheParams
from ..torus import recombine_planar
from .poly import exact_dot_i8


def digit_select_sum(
    a: jax.Array,
    table_limbs: jax.Array,
    t: int,
    basebit: int,
    out_width: int,
) -> jax.Array:
    """Sum of the table rows selected by the digits of `a` (uint32, exact).

    a:           uint32 [..., n_in] mask coefficients to decompose
    table_limbs: int8 [n_in * t * 2^basebit, 4 * P] in the planar-padded
                 layout of tlwe.lwe_encrypt_rows_limbs (P = lane_pad of the
                 row width; padding columns are zero, so they contract and
                 recombine to zero and are sliced off at the end)
    Returns uint32 [..., out_width]. Exposed separately so tensor-parallel
    key switching can `psum` partial sums over a sharded table
    (parallel/sharded.py).
    """
    base = 1 << basebit
    n_in = a.shape[-1]
    p = table_limbs.shape[-1] // 4

    prec_offset = jnp.uint32(1 << (TORUS_BITS - (1 + basebit * t)))
    a_bar = a + prec_offset

    shifts = jnp.asarray(
        np.array([TORUS_BITS - (j + 1) * basebit for j in range(t)], dtype=np.uint32)
    )
    digits = (a_bar[..., None] >> shifts) & jnp.uint32(base - 1)  # [..., n_in, t]
    onehot = (
        digits[..., None] == jnp.arange(base, dtype=jnp.uint32)
    ).astype(jnp.int8)  # [..., n_in, t, base]
    lhs = onehot.reshape(*a.shape[:-1], n_in * t * base)

    acc = exact_dot_i8(lhs, table_limbs)  # [..., 4*P] int32
    acc = acc.reshape(*acc.shape[:-1], 4, p)
    return recombine_planar(acc)[..., :out_width]  # [..., out_width] uint32


def digit_select_subtract(
    a: jax.Array,
    body: jax.Array,
    table_limbs: jax.Array,
    t: int,
    basebit: int,
    out_width: int,
) -> jax.Array:
    """Core of decomposition-based key switching / re-encryption.

    Returns uint32 [..., out_width]:
        (0, ..., 0, body) - sum over selected table rows.
    """
    subtrahend = digit_select_sum(a, table_limbs, t, basebit, out_width)
    res = jnp.zeros((*a.shape[:-1], out_width), dtype=jnp.uint32)
    res = res.at[..., out_width - 1].set(body)
    return res - subtrahend


def identity_key_switch(
    ct: jax.Array, ksk_limbs: jax.Array, params: TfheParams
) -> jax.Array:
    """LWE lv1 [..., N+1] -> LWE lv0 [..., n0+1] (reference trgsw.rs:332-360).

    ksk_limbs: int8 [N*IKS_T*BASE, 4*lane_pad(n0+1)] planar-padded
    (see key.gen_key_switching_key / tlwe.lwe_encrypt_rows_limbs).
    """
    g = params.trgsw_lv1
    n1 = params.n1
    return digit_select_subtract(
        ct[..., :n1], ct[..., n1], ksk_limbs, g.iks_t, g.basebit, params.n0 + 1
    )
