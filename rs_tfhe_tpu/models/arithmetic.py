"""Radix (LUT-based) homomorphic integer arithmetic.

The batch-first analogue of the reference's nibble-LUT method
(rs-tfhe examples/lut_add_two_numbers.rs: 8-bit addition in 3 programmable
bootstraps instead of ~40 gate bootstraps). Integers are vectors of base-2^b
digits, each an LWE message encoded with modulus 2^(b+1) so one digit can
absorb a carry without wrapping.

Per digit position the (result, carry) pair runs as ONE batched programmable
bootstrap with two different test vectors — per-ciphertext LUTs are a single
blind-rotation batch, something the reference's scalar API cannot
express.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..bootstrap import bootstrap, bootstrap_with_testvec
from ..key import CloudKey
from ..lut.generator import Generator
from ..lut.multi_value import factor_test_vectors, multi_value_bootstrap
from ..tlwe import (
    lwe_decrypt_message,
    lwe_encrypt_message,
    lwe_encrypt_torus_seeded,
    lwe_expand_seeded,
    lwe_trivial_message,
)
from ..torus import f64_to_torus


def encrypt_radix(
    key: jax.Array, sk_lv0: jax.Array, val, num_digits: int, params, base_bits: int = 3
):
    """Encrypt integers as [..., num_digits, n0+1] base-2^base_bits digit
    vectors (LSB first), encoded with message modulus 2^(base_bits+1)."""
    val = np.asarray(val)
    digits = np.stack(
        [(val >> (base_bits * i)) & ((1 << base_bits) - 1) for i in range(num_digits)],
        axis=-1,
    )
    modulus = 1 << (base_bits + 1)
    return lwe_encrypt_message(
        key, sk_lv0, jnp.asarray(digits), modulus, params.tlwe_lv0.alpha
    )


def encrypt_radix_seeded(
    key: jax.Array, sk_lv0: jax.Array, val, num_digits: int, params,
    base_bits: int = 3,
):
    """Seeded (compressed) radix encryption: 1 word per DIGIT on the wire.

    Same digit encoding as `encrypt_radix` (LSB first, message modulus
    2^(base_bits+1)), but the LWE masks are replayed from a threefry
    counter stream instead of shipped — (n0+1)x smaller transport, the
    integer analogue of `tlwe.lwe_encrypt_bool_seeded`. Digits flatten
    row-major onto the stream (digit d of value i is stream row i*D+d),
    matching the native C++ client's `lwe_expand_seeded` layout.

    Returns (seed uint32 [2], bodies uint32 [..., num_digits]); the server
    reconstructs with `expand_radix_seeded`. No reference analogue
    (rs-tfhe always ships full masks).
    """
    val = np.asarray(val)
    digits = np.stack(
        [(val >> (base_bits * i)) & ((1 << base_bits) - 1) for i in range(num_digits)],
        axis=-1,
    )
    modulus = 1 << (base_bits + 1)
    scale_t = np.uint32(f64_to_torus(1.0 / (2.0 * modulus)))
    mu = (jnp.asarray(digits) % modulus).astype(jnp.uint32) * scale_t
    seed, bodies = lwe_encrypt_torus_seeded(
        key, sk_lv0, mu.reshape(-1), params.tlwe_lv0.alpha
    )
    return seed, bodies.reshape(mu.shape)


def expand_radix_seeded(seed: jax.Array, bodies: jax.Array, n: int) -> jax.Array:
    """Server-side: (seed, bodies [..., D]) -> full digit vectors [..., D, n+1]."""
    shape = bodies.shape
    ct = lwe_expand_seeded(seed, bodies.reshape(-1), n)
    return ct.reshape(*shape, n + 1)


def decrypt_radix(ct: jax.Array, sk_lv0: jax.Array, base_bits: int = 3):
    """Decrypt [..., D, n0+1] digit vectors back to integers."""
    modulus = 1 << (base_bits + 1)
    digits = np.asarray(lwe_decrypt_message(ct, sk_lv0, modulus))
    val = np.zeros(digits.shape[:-1], dtype=np.int64)
    for i in range(digits.shape[-1]):
        val |= (digits[..., i] & ((1 << base_bits) - 1)) << (base_bits * i)
    return val


@lru_cache(maxsize=64)
def _add_mv(base_bits: int, params):
    """Factored (sum, carry) test-vector family for multi-value add."""
    base = 1 << base_bits
    gen = Generator(2 * base, params)
    return factor_test_vectors([
        gen.generate_lookup_table(lambda x: x % base).poly,
        gen.generate_lookup_table(lambda x: x // base).poly,
    ])


def add_radix(a: jax.Array, b: jax.Array, ck: CloudKey, base_bits: int = 3,
              carry_in: jax.Array | None = None, multi_value: bool = False):
    """Digit-vector addition, 2D - 1 programmable bootstraps for D digits.

    a, b: uint32 [..., D, n0+1]. The linear ciphertext add produces the raw
    digit sum in [0, 2^(b+1)); one PBS extracts sum mod 2^b, a second
    (batched into the same blind rotation) extracts the carry.

    base_bits=4 is the reference's "8-bit add in 3 PBS" nibble method
    (README.md:220). Margins by parameter set (utils.noise.lut_margin):
    the N=1024 sets give ~1-2 sigma at modulus 32 (the reference has the
    same bound, plus an uncentered-decomposition bias we fixed);
    SECURITY_128_BIT_RADIX (N=2048) gives ~3.7 sigma (p ~ 1e-4/PBS, 200x
    the reference's reliability, and 7.3 sigma = certified at base_bits=3);
    SECURITY_128_BIT_NIBBLE (N=4096) certifies base_bits=4 at ~6.5 sigma
    (p < 1e-9) — use it when nibble adds must not fail.

    carry_in: optional [..., n0+1] ciphertext added into digit 0 (the raw
    sum must stay < 2^(b+1) — a 0/1 value; sub_radix uses it for the +1 of
    the radix-complement subtraction).

    multi_value=True runs the (sum, carry) pair through ONE blind rotation
    per digit via test-vector factoring (lut.multi_value) — D rotations
    instead of 2D - 1, decode-identical outputs. Margins: the PBS input
    decision is unchanged (the carry's factoring norm ~1.4 is invisible
    under the keyswitch/modswitch floor), and the sum digit's output norm
    (~1.4 * base) still decodes at > 15 sigma at the certified sets
    (utils.noise.lut_margin(..., mv_norm=...)). Kept opt-in because the
    fixed-seed golden vectors (tests/vectors/) pin the default pipeline's
    exact ciphertexts.
    """
    d = a.shape[-2]
    base = 1 << base_bits
    modulus = 2 * base
    if multi_value:
        mv = _add_mv(base_bits, ck.params)
        carry = carry_in
        outs = []
        for i in range(d):
            s = a[..., i, :] + b[..., i, :]
            if carry is not None:
                s = s + carry
            res = multi_value_bootstrap(s, mv, ck)  # [..., 2, n0+1]
            outs.append(res[..., 0, :])
            carry = res[..., 1, :]
        return jnp.stack(outs, axis=-2)
    gen = Generator(modulus, ck.params)
    lut_mod = gen.generate_lookup_table(lambda x: x % base).poly  # [2, N]
    lut_div = gen.generate_lookup_table(lambda x: x // base).poly

    carry = carry_in
    outs = []
    for i in range(d):
        s = a[..., i, :] + b[..., i, :]
        if carry is not None:
            s = s + carry
        if i + 1 < d:
            pair = jnp.stack([s, s], axis=-2)  # [..., 2, n0+1]
            tv = jnp.broadcast_to(
                jnp.stack([lut_mod, lut_div]), (*s.shape[:-1], 2, *lut_mod.shape)
            )
            res = bootstrap_with_testvec(pair, tv, ck)
            outs.append(res[..., 0, :])
            carry = res[..., 1, :]
        else:
            outs.append(bootstrap_with_testvec(s, lut_mod, ck))
    return jnp.stack(outs, axis=-2)


def sub_radix(a: jax.Array, b: jax.Array, ck: CloudKey, base_bits: int = 3,
              multi_value: bool = False):
    """Digit-vector subtraction a - b (mod base^D), 2D programmable
    bootstraps: a + (base^D - 1 - b) + 1, where the radix complement is
    digit-wise (base-1-b_i) — one batched PBS over all D digits, no borrow
    chain — and the +1 rides add_radix's carry_in. Same margins as
    add_radix (multi_value forwards to it: D+1 rotations total). No
    reference analogue (its LUT demo only adds,
    examples/lut_add_two_numbers.rs)."""
    base = 1 << base_bits
    modulus = 2 * base
    gen = Generator(modulus, ck.params)
    lut_comp = gen.generate_lookup_table(lambda v: (base - 1 - v) % base).poly
    tv = jnp.broadcast_to(lut_comp, (*b.shape[:-1], *lut_comp.shape))
    comp = bootstrap_with_testvec(b, tv, ck)
    one = lwe_trivial_message(
        jnp.ones(a.shape[:-2], dtype=jnp.uint32), modulus, a.shape[-1] - 1
    )
    return add_radix(a, comp, ck, base_bits, carry_in=one,
                     multi_value=multi_value)


def apply_lut_radix(ct: jax.Array, f, ck: CloudKey, base_bits: int = 3):
    """Apply a per-digit function via one batched programmable bootstrap over
    all digit positions (and any outer batch) at once."""
    modulus = 1 << (base_bits + 1)
    lut = Generator(modulus, ck.params).generate_lookup_table(f).poly
    return bootstrap_with_testvec(ct, lut, ck)


def _col_bounds(d: int, base: int) -> list[int]:
    """Exact worst-case column-sum bounds for mul_radix's carry-save stage:
    column k sums (base-1)-valued lo products (i+j=k), hi products
    (i+j=k-1) and the incoming carry. Columns whose bound reaches the
    modulus 2*base^2 need the normalization rounds (D > 4 at base 4);
    below it every column is a single chunk."""
    def n_pairs(k):
        return max(0, min(k, d - 1) - max(0, k - d + 1) + 1)

    bounds, carry = [], 0
    for k in range(2 * d):
        t = (base - 1) * (n_pairs(k) + n_pairs(k - 1)) + carry
        bounds.append(t)
        carry = t // base
    return bounds


def _greedy_chunks(terms, cap_val: int, cap_terms: int):
    """Split [(ct, maxval), ...] into chunks whose summed maxval <= cap_val
    and term count <= cap_terms (both caps protect the modulus-m_col LUT
    decode: value range and summed PBS noise respectively)."""
    chunks, cur, curmax = [], [], 0
    for ct, mx in terms:
        if cur and (curmax + mx > cap_val or len(cur) >= cap_terms):
            chunks.append((cur, curmax))
            cur, curmax = [], 0
        cur.append(ct)
        curmax += mx
    chunks.append((cur, curmax))
    return chunks


@lru_cache(maxsize=64)
def _mul_mv(base_bits: int, params):
    """Factored test-vector family for multi-value mul_radix: the
    bivariate-product stage's (lo, hi) pair shares one blind rotation.

    ONLY stage 2 factors. The column-stage (digit, carry) pairs were
    measured against the noise model and REFUSED: their factoring norms
    (9.8 for the column-scale digit, 39.2 when the digit leaves at the
    m_enc scale — the gcd is set by the fine carry steps while the digit's
    jumps are base^2/2-x coarser) drop the certified NIBBLE 8-summand
    column margin to 5.97 / 3.25 sigma (< the 6-sigma bar;
    tests/test_mul_radix.py pins the numbers). Stage 2's norms (6.3 lo,
    2.8 hi) keep it at 6.27 sigma — and stage 2 is where the rotations
    are (2D^2 of the 2D^2 + 6D total)."""
    base = 1 << base_bits
    m_pair = base * base
    m_col = 2 * base * base
    full32 = np.uint64(1) << 32
    gen_pair = Generator(m_pair, params)
    lut_lo = gen_pair.generate_lookup_table_full(
        lambda w: np.uint32(((w // base) * (w % base) % base) * full32
                            // (2 * m_col) % full32)
    ).poly
    lut_hi = gen_pair.generate_lookup_table_full(
        lambda w: np.uint32(((w // base) * (w % base) // base) * full32
                            // (2 * m_col) % full32)
    ).poly
    return {"pair": factor_test_vectors([lut_lo, lut_hi])}


def mul_radix(a: jax.Array, b: jax.Array, ck: CloudKey, base_bits: int = 2,
              multi_value: bool = False):
    """Ciphertext x ciphertext multiplication over base-2^b digit vectors —
    a capability the reference does not have (its only multiplications are
    plaintext scalars, tlwe.rs:160-214).

    a, b: uint32 [..., D, n0+1] (encrypt_radix encoding). Returns the full
    2D-digit product. Three batched-PBS stages, all margins engineered for
    SECURITY_128_BIT_RADIX (utils.noise.lut_margin):

      1. re-encode (one batched PBS, 2D cts): a_i -> v/(2*base) raw,
         b_j -> v/(2*base^2) raw, so the LINEAR sum base*a_i + b_j becomes
         a modulus-base^2 encoding of the digit pair w = base*v_a + v_b.
      2. bivariate products (one batched per-ct-LUT PBS, 2*D^2 cts):
         lo_ij = (w//base)*(w%base) mod base and hi_ij = .. // base, both
         output at scale 1/(4*base^2) for the column stage.
      3. carry-save columns (sequential in k): column sums are linear;
         when a column's worst-case sum fits the modulus-2*base^2 range
         (every column at D <= 4, base 4 — e.g. 27 < 32) one PBS extracts
         the standard-encoded digit and one the carry. Wider operands
         trigger NORMALIZATION rounds: the column's terms are greedily
         chunked so each chunk's value bound stays < 2*base^2 and its
         summed-PBS-noise count <= max_chunk_terms, every chunk is
         re-split into (digit, carry) by one batched per-ct-LUT PBS, and
         the digits re-enter the column (converges in <= 2 rounds at
         D = 8).

    Total: 2D^2 + 6D programmable bootstraps when no normalization is
    needed (56 for 8-bit x 8-bit); ~2 extra PBS per normalization chunk
    (~230 for 16-bit x 16-bit at base 4), batched over any leading dims.

    Margins: the modulus-32 column stage is the binding one
    (utils.noise.lut_margin(params, 32, max_chunk_terms)): ~6.5 sigma
    (p < 1e-9) at SECURITY_128_BIT_NIBBLE — the certified choice — vs
    ~3.4 sigma (p ~ 7e-4/PBS) at SECURITY_128_BIT_RADIX. max_chunk_terms
    caps summed bootstrap noise per decode at the documented 8.

    multi_value=True (review round 4 item 4) factors stage 2's (lo, hi)
    test-vector pair through ONE blind rotation (lut.multi_value): the
    dominant stage's batch halves from 2D^2 to D^2, decode-identical
    outputs, and the factoring norms (6.3/2.8) keep the certified NIBBLE
    column margin at 6.27 sigma (lut_margin(..., mv_norm=6.3), asserted
    in tests/test_mul_radix.py). Stage 1 has nothing to factor (its two
    LUTs apply to DIFFERENT inputs) and the stage-3 column splits REFUSE
    factoring — their norms (9.8/39.2, see _mul_mv) would drop the margin
    below the 6-sigma bar. Kept opt-in because the fixed-seed golden
    vectors pin the default pipeline's exact ciphertexts.
    """
    d = a.shape[-2]
    base = 1 << base_bits
    m_pair = base * base
    m_col = 2 * base * base
    max_chunk_terms = 8
    m_enc = 1 << (base_bits + 1)  # standard digit encoding modulus

    gen_enc = Generator(m_enc, ck.params)
    full32 = np.uint64(1) << 32
    # stage 1: re-encode digits for pairing (input modulus m_enc)
    lut_a = gen_enc.generate_lookup_table_full(
        lambda v: np.uint32((v % base) * full32 // (2 * base) % full32)
    ).poly
    lut_b = gen_enc.generate_lookup_table_full(
        lambda v: np.uint32((v % base) * full32 // (2 * m_pair) % full32)
    ).poly
    both = jnp.concatenate([a, b], axis=-2)  # [..., 2D, n+1]
    tvs = jnp.concatenate(
        [
            jnp.broadcast_to(lut_a, (*a.shape[:-1], *lut_a.shape)),
            jnp.broadcast_to(lut_b, (*b.shape[:-1], *lut_b.shape)),
        ],
        axis=-3,
    )
    enc = bootstrap_with_testvec(both, tvs, ck)
    a2, b2 = enc[..., :d, :], enc[..., d:, :]

    # stage 2: all D^2 pairs, lo/hi products via per-ciphertext LUTs
    gen_pair = Generator(m_pair, ck.params)
    lut_lo = gen_pair.generate_lookup_table_full(
        lambda w: np.uint32(((w // base) * (w % base) % base) * full32
                            // (2 * m_col) % full32)
    ).poly
    lut_hi = gen_pair.generate_lookup_table_full(
        lambda w: np.uint32(((w // base) * (w % base) // base) * full32
                            // (2 * m_col) % full32)
    ).poly
    pairs = a2[..., :, None, :] + b2[..., None, :, :]  # [..., D, D, n+1]
    pairs = pairs.reshape(*pairs.shape[:-3], d * d, pairs.shape[-1])
    mv = _mul_mv(base_bits, ck.params) if multi_value else None
    if multi_value:
        prod = multi_value_bootstrap(pairs, mv["pair"], ck)  # [..., D^2, 2, n+1]
        lo = prod[..., 0, :].reshape(*a.shape[:-2], d, d, a.shape[-1])
        hi = prod[..., 1, :].reshape(*a.shape[:-2], d, d, a.shape[-1])
    else:
        pp = jnp.concatenate([pairs, pairs], axis=-2)  # lo block then hi block
        tvs2 = jnp.concatenate(
            [
                jnp.broadcast_to(lut_lo, (*pairs.shape[:-1], *lut_lo.shape)),
                jnp.broadcast_to(lut_hi, (*pairs.shape[:-1], *lut_hi.shape)),
            ],
            axis=-3,
        )
        prod = bootstrap_with_testvec(pp, tvs2, ck)
        lo = prod[..., : d * d, :].reshape(*a.shape[:-2], d, d, a.shape[-1])
        hi = prod[..., d * d :, :].reshape(*a.shape[:-2], d, d, a.shape[-1])

    # stage 3: column carry-save with normalization (input modulus m_col)
    gen_col = Generator(m_col, ck.params)
    lut_dig = gen_col.generate_lookup_table_full(
        lambda t: np.uint32((t % base) * full32 // (2 * m_enc) % full32)
    ).poly
    lut_car = gen_col.generate_lookup_table_full(
        lambda t: np.uint32((t % m_col) // base * full32 // (2 * m_col) % full32)
    ).poly
    # normalization digit: back at the COLUMN scale so it re-enters the sum
    lut_dig_col = gen_col.generate_lookup_table_full(
        lambda t: np.uint32((t % base) * full32 // (2 * m_col) % full32)
    ).poly

    pmax = base - 1
    terms = [[] for _ in range(2 * d + 1)]  # [(ct, worst-case value)]
    for i in range(d):
        for j in range(d):
            terms[i + j].append((lo[..., i, j, :], pmax))
            terms[i + j + 1].append((hi[..., i, j, :], pmax))

    outs = []
    for k in range(2 * d):
        tk = terms[k]
        while True:
            chunks = _greedy_chunks(tk, m_col - 1, max_chunk_terms)
            if len(chunks) == 1:
                break
            # one batched per-ct-LUT PBS re-splits every chunk into a
            # column-scale digit (re-enters this column) and a carry
            sums = []
            for ct_list, _ in chunks:
                s = ct_list[0]
                for c in ct_list[1:]:
                    s = s + c
                sums.append(s)
            cs = jnp.stack(sums, axis=-2)  # [..., C, n0+1]
            n_c = len(chunks)
            cc = jnp.concatenate([cs, cs], axis=-2)
            tvs3 = jnp.concatenate(
                [
                    jnp.broadcast_to(lut_dig_col, (*cs.shape[:-1], *lut_dig_col.shape)),
                    jnp.broadcast_to(lut_car, (*cs.shape[:-1], *lut_car.shape)),
                ],
                axis=-3,
            )
            res = bootstrap_with_testvec(cc, tvs3, ck)
            tk = [(res[..., i, :], pmax) for i in range(n_c)]
            terms[k + 1].extend(
                (res[..., n_c + i, :], chunks[i][1] // base) for i in range(n_c)
            )
        (chunk_cts, total) = chunks[0]
        s = chunk_cts[0]
        for ct in chunk_cts[1:]:
            s = s + ct
        if k + 1 < 2 * d and total >= base:
            pair = jnp.stack([s, s], axis=-2)
            tv = jnp.broadcast_to(
                jnp.stack([lut_dig, lut_car]), (*s.shape[:-1], 2, *lut_dig.shape)
            )
            res = bootstrap_with_testvec(pair, tv, ck)
            outs.append(res[..., 0, :])
            terms[k + 1].append((res[..., 1, :], total // base))
        else:
            outs.append(bootstrap_with_testvec(s, lut_dig, ck))
    return jnp.stack(outs, axis=-2)


# ---------------------------------------------------------------------------
# Comparisons and selection over radix digit vectors — capabilities the
# reference does not have (its comparisons exist only as boolean bit
# circuits; there is no encrypted select over LUT-encoded integers).
# ---------------------------------------------------------------------------

_TRI_MOD = 16  # combine-stage modulus: w = 3*t_hi + t_lo in [0, 9) < 16


def _raw(value: int, modulus: int) -> int:
    """Raw torus encoding value/(2*modulus) as an int in [0, 2^32)."""
    return value * (1 << 32) // (2 * modulus) % (1 << 32)


def _bool_raw(flag: bool) -> int:
    """Raw torus of a gate-encoded boolean (+/- 1/8)."""
    mu = int(f64_to_torus(0.125))
    return mu if flag else (1 << 32) - mu


def _tri(v: int, base: int) -> int:
    """Trichotomy of the shifted digit difference v = a_i - b_i + base:
    0 = equal, 1 = a > b, 2 = a < b."""
    return 0 if v == base else (1 if v > base else 2)


def _tri_combine(w: int) -> int:
    """Merge two trichotomies packed as w = 3*t_hi + t_lo: the higher digit
    wins unless it says equal."""
    q = w // 3
    return q if q else w % 3


@lru_cache(maxsize=64)
def _cmp_luts(base_bits: int, params):
    """Device LUT polynomials for compare_radix (cached per parameter set)."""
    base = 1 << base_bits
    gen_in = Generator(2 * base, params)
    gen_w = Generator(_TRI_MOD, params)
    t = lambda v: _tri(v, base)  # noqa: E731
    return {
        # leaf stage: shifted difference (modulus 2*base) -> trichotomy at
        # the two combine scales (3t and t, modulus 16)
        "leaf_e3": gen_in.generate_lookup_table_full(
            lambda v: _raw(3 * t(v), _TRI_MOD)).poly,
        "leaf_e1": gen_in.generate_lookup_table_full(
            lambda v: _raw(t(v), _TRI_MOD)).poly,
        # tree stage: w = 3*t_hi + t_lo -> merged trichotomy, same scales
        "comb_e3": gen_w.generate_lookup_table_full(
            lambda w: _raw(3 * _tri_combine(w), _TRI_MOD)).poly,
        "comb_e1": gen_w.generate_lookup_table_full(
            lambda w: _raw(_tri_combine(w), _TRI_MOD)).poly,
        # final stages: trichotomy -> (eq, gt, lt) gate-encoded booleans
        "leaf_bool": jnp.stack([
            gen_in.generate_lookup_table_full(
                lambda v, k=k: _bool_raw(t(v) == k)).poly
            for k in range(3)
        ]),
        "comb_bool": jnp.stack([
            gen_w.generate_lookup_table_full(
                lambda w, k=k: _bool_raw(_tri_combine(w) == k)).poly
            for k in range(3)
        ]),
    }


@lru_cache(maxsize=64)
def _cmp_mv(base_bits: int, params):
    """Factored test-vector families for multi-value compare_radix."""
    luts = _cmp_luts(base_bits, params)
    return {
        "leaf": factor_test_vectors([luts["leaf_e3"], luts["leaf_e1"]]),
        "comb": factor_test_vectors([luts["comb_e3"], luts["comb_e1"]]),
        "leaf_bool": factor_test_vectors(list(luts["leaf_bool"])),
        "comb_bool": factor_test_vectors(list(luts["comb_bool"])),
    }


def compare_radix(a: jax.Array, b: jax.Array, ck: CloudKey, base_bits: int = 3,
                  multi_value: bool = False):
    """Encrypted comparison of two radix digit vectors: returns the triple
    (eq, gt, lt) of boolean ciphertexts (gates/FheBool +/-1/8 encoding),
    gt meaning a > b.

    MSB-first trichotomy tree: one batched PBS maps each digit's shifted
    difference a_i - b_i + base (modulus 2*base, always in [1, 2*base-1] so
    it never leaves the padding half) to its {equal, greater, less} verdict,
    emitted at TWO torus scales (3t and t at modulus 16) so the linear sum
    w = 3*t_hi + t_lo of adjacent tree nodes feeds one bivariate combine
    LUT per level ("highest non-equal digit wins"). The last level emits
    all three booleans from one blind rotation. Total batched blind
    rotations: 1 + ceil(log2 D) for D digits (1 for D = 1).

    Margins: the leaf stage sums 2 fresh/bootstrapped ciphertexts at
    modulus 2*base, the combine stage sums 2 PBS outputs at modulus 16 —
    both at or inside add_radix's certified envelope
    (utils.noise.lut_margin(params, 2*base, 2) / (params, 16, 2)), so
    compare_radix is certified wherever add_radix is.

    multi_value=True factors each stage's duplicated test vectors through
    one blind rotation (lut.multi_value): the leaf emits (e3, e1) and the
    final node all three booleans from a single rotation each — about half
    the rotations, decode-identical verdicts. The factoring norms (<= 17)
    scale only the accumulator noise, 2 orders below the modswitch floor
    at the certified sets, so the margins above move by < 2%
    (utils.noise.lut_margin(..., mv_norm=17) vs mv_norm=1).
    """
    d = a.shape[-2]
    luts = _cmp_luts(base_bits, ck.params)
    mvs = _cmp_mv(base_bits, ck.params) if multi_value else None
    diff = a - b
    # + base at the modulus-2*base scale = + base/(4*base) = exactly 1/4
    diff = diff.at[..., -1].add(jnp.uint32(1 << 30))

    def _three(ct, polys, mv):
        if multi_value:
            res = multi_value_bootstrap(ct, mv, ck)  # [..., 3, n0+1]
        else:
            trip = jnp.stack([ct, ct, ct], axis=-2)
            tvs = jnp.broadcast_to(polys, (*ct.shape[:-1], *polys.shape))
            res = bootstrap_with_testvec(trip, tvs, ck)
        return res[..., 0, :], res[..., 1, :], res[..., 2, :]

    if d == 1:
        return _three(diff[..., 0, :], luts["leaf_bool"],
                      mvs["leaf_bool"] if multi_value else None)

    if multi_value:
        res = multi_value_bootstrap(diff, mvs["leaf"], ck)  # [..., D, 2, n0+1]
        nodes = [(res[..., i, 0, :], res[..., i, 1, :]) for i in range(d)]
    else:
        both = jnp.concatenate([diff, diff], axis=-2)  # [..., 2D, n0+1]
        tvs = jnp.concatenate(
            [
                jnp.broadcast_to(luts["leaf_e3"], (*diff.shape[:-1], 2, luts["leaf_e3"].shape[-1])),
                jnp.broadcast_to(luts["leaf_e1"], (*diff.shape[:-1], 2, luts["leaf_e1"].shape[-1])),
            ],
            axis=-3,
        )
        res = bootstrap_with_testvec(both, tvs, ck)
        # (e3, e1) per digit, LSB first
        nodes = [(res[..., i, :], res[..., d + i, :]) for i in range(d)]

    while True:
        ws = [nodes[i + 1][0] + nodes[i][1] for i in range(0, len(nodes) - 1, 2)]
        leftover = [nodes[-1]] if len(nodes) % 2 else []
        if len(ws) == 1 and not leftover:
            return _three(ws[0], luts["comb_bool"],
                          mvs["comb_bool"] if multi_value else None)
        stack_w = jnp.stack(ws, axis=-2)
        k = len(ws)
        if multi_value:
            res = multi_value_bootstrap(stack_w, mvs["comb"], ck)
            nodes = [(res[..., i, 0, :], res[..., i, 1, :]) for i in range(k)] + leftover
            continue
        both = jnp.concatenate([stack_w, stack_w], axis=-2)
        tvs = jnp.concatenate(
            [
                jnp.broadcast_to(luts["comb_e3"], (*stack_w.shape[:-1], 2, luts["comb_e3"].shape[-1])),
                jnp.broadcast_to(luts["comb_e1"], (*stack_w.shape[:-1], 2, luts["comb_e1"].shape[-1])),
            ],
            axis=-3,
        )
        res = bootstrap_with_testvec(both, tvs, ck)
        nodes = [(res[..., i, :], res[..., k + i, :]) for i in range(k)] + leftover


@lru_cache(maxsize=64)
def _sel_luts(base_bits: int, params):
    """Device LUT polynomials for select_radix (cached per parameter set)."""
    base = 1 << base_bits
    m = 2 * base
    gen = Generator(m, params)
    return {
        # w = base*sel + digit: keep the branch its mask selects, else 0
        "take": gen.generate_lookup_table_full(
            lambda w: _raw(w - base, m) if w >= base else 0).poly,
        "drop": gen.generate_lookup_table_full(
            lambda w: 0 if w >= base else _raw(w, m)).poly,
        "ident": gen.generate_lookup_table_full(
            lambda v: _raw(v % base, m)).poly,
    }


def select_radix(sel: jax.Array, t: jax.Array, f: jax.Array, ck: CloudKey,
                 base_bits: int = 3, refresh: bool = True):
    """Encrypted select over radix digit vectors: sel ? t : f, element-wise.

    sel: boolean ciphertext [..., n0+1] (+/-1/8 gate encoding, e.g. a
    compare_radix output or any gate result); t, f: [..., D, n0+1] digit
    vectors. Three batched blind rotations: (1) a gate bootstrap turns sel
    into a {0, 1/4} torus mask, (2) per-digit bivariate LUTs on
    w = base*sel + digit (modulus 2*base) zero out the unselected branch
    of each digit, so the linear sum of the two masked branches is the
    selected digit with 2-PBS noise, (3) an identity PBS refreshes it to
    fresh-digit noise (skippable with refresh=False when the result only
    feeds another PBS stage that tolerates 2 summands).
    """
    d = t.shape[-2]
    luts = _sel_luts(base_bits, ck.params)
    mask = bootstrap(sel, ck)  # +/- 1/8
    mask = mask.at[..., -1].add(jnp.uint32(int(f64_to_torus(0.125))))  # {0, 1/4}
    wt = t + mask[..., None, :]
    wf = f + mask[..., None, :]
    both = jnp.concatenate([wt, wf], axis=-2)
    tvs = jnp.concatenate(
        [
            jnp.broadcast_to(luts["take"], (*wt.shape[:-1], 2, luts["take"].shape[-1])),
            jnp.broadcast_to(luts["drop"], (*wf.shape[:-1], 2, luts["drop"].shape[-1])),
        ],
        axis=-3,
    )
    res = bootstrap_with_testvec(both, tvs, ck)
    out = res[..., :d, :] + res[..., d:, :]
    if refresh:
        out = bootstrap_with_testvec(out, luts["ident"], ck)
    return out


def min_radix(a: jax.Array, b: jax.Array, ck: CloudKey, base_bits: int = 3,
              multi_value: bool = False):
    """Encrypted min of two radix digit vectors (compare + select)."""
    _, _, lt = compare_radix(a, b, ck, base_bits, multi_value=multi_value)
    return select_radix(lt, a, b, ck, base_bits)


def max_radix(a: jax.Array, b: jax.Array, ck: CloudKey, base_bits: int = 3,
              multi_value: bool = False):
    """Encrypted max of two radix digit vectors (compare + select)."""
    _, _, lt = compare_radix(a, b, ck, base_bits, multi_value=multi_value)
    return select_radix(lt, b, a, ck, base_bits)


# ---------------------------------------------------------------------------
# Radix <-> bit-level conversion (casts between the two integer worlds).
# No reference analogue: its LUT encoding and bit encoding never interoperate
# (examples/lut_add_two_numbers.rs decrypts in between).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _cast_luts(base_bits: int, params):
    """Device LUTs for radix<->bits conversion (cached per parameter set)."""
    base = 1 << base_bits
    m = 2 * base
    gen = Generator(m, params)
    return {
        # digit -> its j-th bit as a gate-encoded boolean
        "bits": jnp.stack([
            gen.generate_lookup_table_full(
                lambda v, j=j: _bool_raw(((v % base) >> j) & 1)).poly
            for j in range(base_bits)
        ]),
        "ident": gen.generate_lookup_table_full(
            lambda v: _raw(v % base, m)).poly,
    }


def radix_to_bits(ct: jax.Array, ck: CloudKey, base_bits: int = 3) -> jax.Array:
    """Convert radix digit vectors [..., D, n0+1] to gate-encoded boolean bit
    vectors [..., D*base_bits, n0+1] (LSB first, bit_utils layout) in ONE
    batched blind rotation: each digit is repeated base_bits times and paired
    with a per-ciphertext bit-extraction LUT. Margin: single-summand PBS at
    modulus 2*base — the widest envelope in this module."""
    d = ct.shape[-2]
    luts = _cast_luts(base_bits, ck.params)
    rep = jnp.repeat(ct, base_bits, axis=-2)  # [..., D*b, n0+1]
    tvs = jnp.tile(luts["bits"], (d, 1, 1))  # [D*b, 2, N]
    tvs = jnp.broadcast_to(tvs, (*rep.shape[:-2], *tvs.shape))
    return bootstrap_with_testvec(rep, tvs, ck)


def bits_to_radix(bits: jax.Array, ck: CloudKey, base_bits: int = 3,
                  num_digits: int | None = None) -> jax.Array:
    """Convert gate-encoded boolean bit vectors [..., W, n0+1] (LSB first) to
    radix digit vectors [..., ceil(W/b), n0+1]. Two batched blind rotations:

      1. each bit bootstraps against a constant test vector of amplitude
         2^j/(4*base)/2 (j = bit position within its digit), so
         +trivial-shift turns the +/-amplitude sign output into a
         {0, encode(2^j)} mask;
      2. the per-digit linear sum of its masks (value = the digit, noise =
         up to base_bits PBS outputs) is refreshed by one identity PBS.

    Margin: the refresh decodes a base_bits-summand sum at modulus 2*base —
    lut_margin(params, 2*base, base_bits); at SECURITY_128_BIT_RADIX
    (b=3, modulus 16, 3 summands) exactly the certified add_radix envelope.
    """
    w = bits.shape[-2]
    base = 1 << base_bits
    n1 = ck.params.n1
    d = num_digits if num_digits is not None else -(-w // base_bits)
    if w > d * base_bits:
        raise ValueError(f"{w} bits do not fit {d} base-2^{base_bits} digits")
    luts = _cast_luts(base_bits, ck.params)

    # constant test vectors: amplitude c_j = encode(2^j)/2 — half the digit
    # encoding 2^j/(4*base) = 2^(30-base_bits+j), so the +/-c sign output
    # plus the trivial +c shift lands exactly on {0, encode(2^j)}
    cs = [1 << (30 + j - (base_bits + 1)) for j in range(base_bits)]
    tv_js = jnp.stack([
        jnp.stack([jnp.zeros((n1,), jnp.uint32),
                   jnp.full((n1,), jnp.uint32(c))])
        for c in cs
    ])  # [b, 2, N]
    order = jnp.asarray([j % base_bits for j in range(w)])
    tvs = tv_js[order]  # [W, 2, N]
    tvs = jnp.broadcast_to(tvs, (*bits.shape[:-2], *tvs.shape))
    masks = bootstrap_with_testvec(bits, tvs, ck)  # +/- c_j
    shift = jnp.asarray([cs[j % base_bits] for j in range(w)], jnp.uint32)
    masks = masks.at[..., -1].add(shift)  # broadcast over the bit axis

    # per-digit linear sums (pad the top digit's missing bits with nothing)
    digits = []
    for i in range(d):
        lo, hi = i * base_bits, min((i + 1) * base_bits, w)
        s = masks[..., lo, :]
        for k in range(lo + 1, hi):
            s = s + masks[..., k, :]
        digits.append(s)
    out = jnp.stack(digits, axis=-2)
    return bootstrap_with_testvec(out, luts["ident"], ck)


def shift_digits(ct: jax.Array, k: int, base_bits: int = 3) -> jax.Array:
    """Multiply/divide by base^k mod base^D — free digit-row moves, no PBS.
    Positive k shifts toward the MSB (multiply), negative divides."""
    d, n = ct.shape[-2], ct.shape[-1]
    if k == 0:
        return ct
    zeros = jnp.zeros((*ct.shape[:-2], min(abs(k), d), n), dtype=ct.dtype)
    if k > 0:
        return jnp.concatenate([zeros, ct[..., : max(d - k, 0), :]], axis=-2)
    return jnp.concatenate([ct[..., min(-k, d):, :], zeros], axis=-2)
