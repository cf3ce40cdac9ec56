"""Bootstrap strategies: vanilla and programmable (LUT).

Mirrors the reference's strategy trait (bootstrap/mod.rs:23-43) so users can
inject a strategy into `Gates`; the core pipelines are plain functions usable
directly under `jit`.
"""

from __future__ import annotations

import jax

from .key import CloudKey
from .ops.blind_rotate import blind_rotate
from .ops.extract import sample_extract
from .ops.keyswitch import identity_key_switch


def _flat(ct: jax.Array):
    """Collapse arbitrary leading batch dims to the single batch axis the
    blind-rotation scan expects; returns (flat_ct, restore_fn)."""
    lead = ct.shape[:-1]
    flat = ct.reshape(-1, ct.shape[-1])
    return flat, lambda out: out.reshape(*lead, out.shape[-1])


def bootstrap(ct: jax.Array, ck: CloudKey) -> jax.Array:
    """Full gate bootstrap: blind rotate -> extract(0) -> key switch.

    ct: uint32 [..., n0+1] -> uint32 [..., n0+1]. Reference: vanilla.rs:40-52.
    """
    flat, restore = _flat(ct)
    acc = blind_rotate(flat, ck.testvec, ck.bsk, ck.params, bsk_mb=ck.bsk_mb)
    lv1 = sample_extract(acc, 0)
    return restore(identity_key_switch(lv1, ck.ksk_limbs, ck.params))


def bootstrap_without_key_switch(ct: jax.Array, ck: CloudKey) -> jax.Array:
    """Blind rotate + extract, staying at lv1: uint32 [..., N+1].

    Deviation from the reference (vanilla.rs:54-63), which truncates the lv1
    mask to n0 coefficients producing an undecryptable "hybrid" ciphertext;
    we return the full lv1 LWE so callers can combine linearly and key-switch
    once (see gates.mux).
    """
    flat, restore = _flat(ct)
    acc = blind_rotate(flat, ck.testvec, ck.bsk, ck.params, bsk_mb=ck.bsk_mb)
    return restore(sample_extract(acc, 0))


def bootstrap_with_testvec(
    ct: jax.Array, testvec: jax.Array, ck: CloudKey,
    allow_mb: bool | None = None,
) -> jax.Array:
    """Programmable bootstrap against a caller-supplied test vector.

    ct: uint32 [..., n0+1]; testvec: uint32 [2, N] (shared) or [..., 2, N]
    (per-ciphertext LUTs). Reference: trgsw.rs:242-274 + bootstrap/lut.rs:79-99.

    allow_mb: whether a multi-bit CloudKey may route tiny batches through the
    pair-grouped chain. Default (None) applies the noise policy
    `utils.noise.mb_lut_route_ok`: the route engages only where it moves
    every LUT decision margin by < 1% (true at the certified RADIX/NIBBLE
    sets, false at FAST/strict whose rotation noise dominates their budget).
    Boolean-gate callers with their own published mb margins pass True
    (bootstrap() above routes unconditionally — gates opted in via
    CloudKey.generate(multibit=True)).
    """
    if allow_mb is None:
        from .utils.noise import mb_lut_route_ok

        allow_mb = mb_lut_route_ok(ck.params)
    flat, restore = _flat(ct)
    if testvec.ndim > 2:
        testvec = testvec.reshape(-1, *testvec.shape[-2:])
    acc = blind_rotate(flat, testvec, ck.bsk, ck.params,
                       bsk_mb=ck.bsk_mb if allow_mb else None)
    lv1 = sample_extract(acc, 0)
    return restore(identity_key_switch(lv1, ck.ksk_limbs, ck.params))


class VanillaBootstrap:
    """Standard TFHE bootstrapping (reference bootstrap/vanilla.rs)."""

    name = "vanilla"

    def bootstrap(self, ct, ck):
        return bootstrap(ct, ck)

    def bootstrap_gate(self, ct, ck):
        """Refresh a gate-linear-form ciphertext (+/-1/8 boolean encoding)."""
        return bootstrap(ct, ck)

    def bootstrap_without_key_switch(self, ct, ck):
        return bootstrap_without_key_switch(ct, ck)


class LutBootstrap:
    """Programmable bootstrapping strategy (reference bootstrap/lut.rs).

    Unlike the reference — which rebuilds the LUT polynomial from the
    closure on EVERY call inside the hot path (lut.rs:49-65, a host-side
    loop per bootstrap) — repeated (f, modulus, params) pairs hit a
    per-strategy LUT cache, so steady-state pipelines never leave the
    device. Pass a stable function object (not a fresh lambda per call) to
    benefit; `bootstrap_lut` with a prebuilt LookupTable is the fully
    explicit route."""

    name = "lut"

    def __init__(self):
        self._lut_cache: dict = {}

    # Bounded so caches keyed by fresh lambdas can't grow without limit.
    _LUT_CACHE_MAX = 64

    def bootstrap_func(self, ct, f, message_modulus: int, ck: CloudKey):
        # TfheParams is a frozen (hashable) dataclass — key on it directly.
        # (id(params) could be reused by a new object after a GC, silently
        # returning a LUT built for different parameters.)
        key = (f, message_modulus, ck.params)
        lut = self._lut_cache.get(key)
        if lut is None:
            from .lut.generator import Generator

            lut = Generator(message_modulus, ck.params).generate_lookup_table(f)
            if len(self._lut_cache) >= self._LUT_CACHE_MAX:
                self._lut_cache.pop(next(iter(self._lut_cache)))
            self._lut_cache[key] = lut
        return self.bootstrap_lut(ct, lut, ck)

    def bootstrap_lut(self, ct, lut, ck: CloudKey):
        return bootstrap_with_testvec(ct, lut.poly, ck)

    def bootstrap(self, ct, ck):
        # identity over the mod-2 MESSAGE encoding (m/(2*modulus), centered
        # in the LUT ranges — reference lut.rs:109-112). NOT valid for gate
        # linear forms; see bootstrap_gate.
        return self.bootstrap_func(ct, lambda x: x, 2, ck)

    def bootstrap_gate(self, ct, ck):
        """Refresh a gate-linear-form ciphertext (+/-1/8 boolean encoding)
        via the sign test vector.

        Deviation from the reference, whose Gates-with-LUT-strategy path
        routes gate ciphertexts through the identity-mod-2 LUT above
        (gates.rs:30-49 + lut.rs:109-112): boolean gate phases (+/-1/8,
        +/-3/8) land exactly on that LUT's range boundaries, so gates
        evaluate correctly only ~50-80% of the time (confirmed empirically).
        The sign test vector is the correct identity over the boolean
        encoding. allow_mb=True: this is a boolean-gate decode with the
        gates' own published mb margins, same as the vanilla path."""
        return bootstrap_with_testvec(ct, ck.testvec, ck, allow_mb=True)

    def bootstrap_without_key_switch(self, ct, ck):
        """Same lv1 output contract as VanillaBootstrap (the reference's
        lut.rs:114-121 instead falls back to a full key-switched bootstrap,
        making the two strategies disagree on this method's output type)."""
        return bootstrap_without_key_switch(ct, ck)


def default_bootstrap() -> VanillaBootstrap:
    """Reference: bootstrap/mod.rs:41-43."""
    return VanillaBootstrap()
