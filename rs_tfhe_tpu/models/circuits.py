"""Homomorphic boolean circuits over encrypted bit vectors.

The framework analogue of the reference's example circuits
(rs-tfhe examples/add_two_numbers.rs: a 16-bit ripple-carry adder evaluated
gate by gate) — plus batch-first designs the reference cannot express: a
Kogge-Stone adder whose every level runs ALL bit positions through one
batched bootstrap, turning the O(W) serial gate chain into O(log W) batched
gate rounds on the device.

Encrypted integers are bit batches uint32 [..., W, n0+1], LSB first
(bit_utils.py). All circuits accept arbitrary leading batch dims, so a batch
of B additions of W-bit numbers is one [B, W]-shaped gate batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import gates
from ..key import CloudKey


def _shift_up(x: jax.Array, k: int, fill: jax.Array) -> jax.Array:
    """Shift a bit-batch [..., W, n+1] towards the MSB by k positions,
    filling vacated low bits with `fill` rows (e.g. trivial-false)."""
    w = x.shape[-2]
    pad = jnp.broadcast_to(fill, (*x.shape[:-2], k, x.shape[-1]))
    return jnp.concatenate([pad, x[..., : w - k, :]], axis=-2)


def add_kogge_stone(a: jax.Array, b: jax.Array, ck: CloudKey) -> jax.Array:
    """W-bit addition (mod 2^W) in 2 + 2*ceil(log2 W) batched gate rounds.

    a, b: uint32 [..., W, n0+1] bit batches. Parallel-prefix carry network:
      g = a AND b, p = a XOR b                       (2 batched gates)
      for k in 1,2,4,...: g |= (p AND g>>k); p &= p>>k   (2 gates per level)
      sum = p0 XOR (g << 1)                          (1 batched gate)
    Every gate round bootstraps all W bit positions (and any outer batch)
    together — the reference evaluates the same adder one gate at a time
    (examples/add_two_numbers.rs:60-97).
    """
    w = a.shape[-2]
    false_ct = gates.constant(False, 1, ck.params)[0]
    true_ct = gates.constant(True, 1, ck.params)[0]

    p0 = gates.xor(a, b, ck)  # propagate, kept for the final sum
    g = gates.and_(a, b, ck)  # generate
    p = p0
    k = 1
    while k < w:
        g_k = _shift_up(g, k, false_ct)
        p_k = _shift_up(p, k, true_ct)
        # g = g OR (p AND g_k); p = p AND p_k
        g = gates.or_(g, gates.and_(p, g_k, ck), ck)
        p = gates.and_(p, p_k, ck)
        k *= 2
    carry_in = _shift_up(g, 1, false_ct)  # carry into each position
    return gates.xor(p0, carry_in, ck)


def add_ripple_carry(a: jax.Array, b: jax.Array, ck: CloudKey) -> jax.Array:
    """W-bit ripple-carry addition (mod 2^W): the reference's adder shape
    (examples/add_two_numbers.rs:60-97), 5 gate-bootstraps per bit, serial
    in the carry. Kept for parity/verification; prefer add_kogge_stone.
    """
    w = a.shape[-2]
    carry = gates.constant(False, 1, ck.params)
    carry = jnp.broadcast_to(carry[0], (*a.shape[:-2], a.shape[-1]))
    outs = []
    for i in range(w):
        ai, bi = a[..., i, :], b[..., i, :]
        axb = gates.xor(ai, bi, ck)
        outs.append(gates.xor(axb, carry, ck))
        if i + 1 < w:
            # carry' = (a AND b) OR (carry AND (a XOR b)) == MUX(axb; carry; a AND b)
            carry = gates.mux(axb, carry, gates.and_(ai, bi, ck), ck)
    return jnp.stack(outs, axis=-2)


def sub(a: jax.Array, b: jax.Array, ck: CloudKey) -> jax.Array:
    """W-bit subtraction a - b (mod 2^W): a + NOT(b) + 1 via Kogge-Stone with
    the +1 folded in as an extra generate at bit 0."""
    w = a.shape[-2]
    nb = gates.not_(b)
    false_ct = gates.constant(False, 1, ck.params)[0]
    true_ct = gates.constant(True, 1, ck.params)[0]

    p0 = gates.xor(a, nb, ck)
    g = gates.and_(a, nb, ck)
    # inject carry-in = 1 at bit 0: g0 |= p0[0], then sum bit 0 flips
    g0 = gates.or_(g[..., :1, :], p0[..., :1, :], ck)
    g = jnp.concatenate([g0, g[..., 1:, :]], axis=-2)
    p = p0
    k = 1
    while k < w:
        g_k = _shift_up(g, k, false_ct)
        p_k = _shift_up(p, k, true_ct)
        g = gates.or_(g, gates.and_(p, g_k, ck), ck)
        p = gates.and_(p, p_k, ck)
        k *= 2
    carry_in = _shift_up(g, 1, false_ct)
    carry_in = jnp.concatenate(
        [jnp.broadcast_to(true_ct, carry_in[..., :1, :].shape), carry_in[..., 1:, :]],
        axis=-2,
    )
    return gates.xor(p0, carry_in, ck)


def mul_csa(a: jax.Array, b: jax.Array, ck: CloudKey) -> jax.Array:
    """W-bit multiply (mod 2^W) via a carry-save (Wallace) reduction —
    review round 4 weak item 6: the old schoolbook multiply ran W-1 SEQUENTIAL
    Kogge-Stone adds (~10 gate rounds each); here every reduction level
    compresses all 3-rows groups AT ONCE (they stack on a fresh leading
    batch axis, so one level = 4 batched gate rounds regardless of W):

      partials: one batched AND builds all W shifted rows       (1 round)
      3:2 compressors: s = a^b^c, carry = (a&b) | (c&(a^b)),
        groups batched together                 (4 rounds per tree level)
      final: one Kogge-Stone add                (2 + 2*ceil(log2 W) rounds)

    Sequential bootstrapped rounds: 1 + 4*ceil(log1.5 W) + KS — e.g. W=16:
    ~35 vs the schoolbook's ~155. The radix path (mul_radix) remains the
    PBS-count champion; this is the bit-circuit multiply done right.
    """
    w = a.shape[-2]
    false_ct = gates.constant(False, 1, ck.params)[0]

    # all W partial products in ONE batched AND: partial i = (a << i) AND b_i
    shifted = jnp.stack(
        [_shift_up(a, i, false_ct) if i else a for i in range(w)], axis=0
    )  # [W, ..., W, n+1]
    bi = jnp.stack(
        [jnp.broadcast_to(b[..., i : i + 1, :], a.shape) for i in range(w)],
        axis=0,
    )
    rows = list(gates.and_(shifted, bi, ck))  # W arrays [..., W, n+1]

    while len(rows) > 2:
        n3 = len(rows) // 3
        rest = rows[3 * n3 :]
        if n3 == 0:
            break
        aa = jnp.stack(rows[0 : 3 * n3 : 3], axis=0)
        bb = jnp.stack(rows[1 : 3 * n3 : 3], axis=0)
        cc = jnp.stack(rows[2 : 3 * n3 : 3], axis=0)
        axb = gates.xor(aa, bb, ck)
        s = gates.xor(axb, cc, ck)
        # maj(a, b, c) = (a & b) | (c & (a ^ b)) — the two ANDs batch as one
        ands = gates.and_(
            jnp.concatenate([aa, cc], axis=0),
            jnp.concatenate([bb, axb], axis=0),
            ck,
        )
        carry = gates.or_(ands[:n3], ands[n3:], ck)
        carry = _shift_up(carry, 1, false_ct)  # weight doubles
        rows = list(s) + list(carry) + rest
    if len(rows) == 1:
        return rows[0]
    return add_kogge_stone(rows[0], rows[1], ck)


def equals(a: jax.Array, b: jax.Array, ck: CloudKey) -> jax.Array:
    """Encrypted equality of two W-bit integers -> one ciphertext [..., n0+1].

    One batched XNOR over all bits, then a log-depth AND tree (each level one
    batched gate). The reference only sketched this (src/circuits.rs, dead)."""
    x = gates.xnor(a, b, ck)  # [..., W, n0+1]
    true_ct = gates.constant(True, 1, ck.params)[0]
    while x.shape[-2] > 1:
        w = x.shape[-2]
        half = (w + 1) // 2
        lo = x[..., :half, :]
        hi = x[..., half:, :]
        if hi.shape[-2] < half:  # pad odd widths with trivial TRUE
            pad = jnp.broadcast_to(
                true_ct, (*hi.shape[:-2], half - hi.shape[-2], hi.shape[-1])
            )
            hi = jnp.concatenate([hi, pad], axis=-2)
        x = gates.and_(lo, hi, ck)
    return x[..., 0, :]


def divmod_bits(n: jax.Array, d: jax.Array, ck: CloudKey):
    """Encrypted (n // d, n % d) for W-bit unsigned integers — restoring
    long division, a capability the reference does not have.

    n, d: uint32 [..., W, n0+1] bit batches. W rounds, each: shift a bit of
    n into a (W+1)-bit partial remainder (free row moves), one comparator
    (remainder >= d), one Kogge-Stone subtract and one batched MUX —
    O(W^2) bootstrapped gates total, every round batched over all leading
    dims. Division by an encrypted zero follows the usual FHE convention:
    quotient = 2^W - 1, remainder = n (nothing is revealed).
    """
    w = n.shape[-2]
    false_ct = gates.constant(False, 1, ck.params)[0]
    zero_row = jnp.broadcast_to(false_ct, (*n.shape[:-2], 1, n.shape[-1]))
    # (W+1)-bit working width: after the restoring step R < d <= 2^W - 1,
    # so 2R + bit fits in W+1 bits
    d_ext = jnp.concatenate([d, zero_row], axis=-2)
    rem = jnp.broadcast_to(false_ct, (*n.shape[:-2], w + 1, n.shape[-1]))
    q_bits = []
    for i in reversed(range(w)):
        rem = jnp.concatenate([n[..., i : i + 1, :], rem[..., :w, :]], axis=-2)
        ge = gates.not_(greater_than(d_ext, rem, ck))  # rem >= d
        diff = sub(rem, d_ext, ck)
        sel = jnp.broadcast_to(ge[..., None, :], rem.shape)
        rem = gates.mux(sel, diff, rem, ck)
        q_bits.append(ge)
    q = jnp.stack(q_bits[::-1], axis=-2)  # collected MSB-first
    return q, rem[..., :w, :]


def greater_than(a: jax.Array, b: jax.Array, ck: CloudKey) -> jax.Array:
    """Encrypted a > b (unsigned) -> one ciphertext [..., n0+1].

    MSB-down MUX chain: result = MUX(a_i XNOR b_i, result_so_far, a_i AND
    NOT b_i); serial depth W like the classic comparator circuit."""
    w = a.shape[-2]
    false_ct = gates.constant(False, 1, ck.params)[0]
    res = jnp.broadcast_to(false_ct, (*a.shape[:-2], a.shape[-1]))
    for i in range(w):  # LSB -> MSB so the MSB decides last
        ai, bi = a[..., i, :], b[..., i, :]
        eq = gates.xnor(ai, bi, ck)
        gt = gates.and_yn(ai, bi, ck)  # a AND (NOT b)
        res = gates.mux(eq, res, gt, ck)
    return res
