"""ctypes bindings for the native client runtime (csrc/tfhe_client.cpp).

The C++ library provides exact torus/LWE client operations for environments
without JAX — the framework's counterpart to the reference's vendored
SPQLIOS C++ core (rs-tfhe src/fft/spqlios/). The shared object is built with
`make -C csrc`; if missing, `build()` compiles it on demand with g++ and
`available()` reports False until then.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SO = _DIR / "libtfhe_client.so"
_SRCS = [
    _DIR.parent.parent / "csrc" / "tfhe_client.cpp",
    _DIR.parent.parent / "csrc" / "circuit_scheduler.cpp",
]
_lib = None


def build(force: bool = False) -> Path:
    """Compile the shared library with g++ (idempotent)."""
    if force or not _SO.exists():
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                "-shared", "-o", str(_SO), *[str(s) for s in _SRCS],
            ],
            check=True,
        )
    return _SO


def _load():
    global _lib
    if _lib is None:
        if not _SO.exists():
            build()
        lib = ctypes.CDLL(str(_SO))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.negacyclic_polymul_u32.argtypes = [u32p, u32p, u32p, ctypes.c_int32]
        lib.negacyclic_monomial_rotate_u32.argtypes = [
            u32p, u32p, ctypes.c_int32, ctypes.c_int32]
        lib.lwe_encrypt_batch.argtypes = [
            ctypes.c_uint64, u32p, u32p, ctypes.c_double, u32p,
            ctypes.c_int32, ctypes.c_int32]
        lib.lwe_phase_batch.argtypes = [u32p, u32p, u32p, ctypes.c_int32, ctypes.c_int32]
        lib.lwe_decrypt_bool_batch.argtypes = [
            u32p, u32p, u8p, ctypes.c_int32, ctypes.c_int32]
        lib.gadget_decompose_batch.argtypes = [
            u32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint32]
        lib.identity_key_switch.argtypes = [
            u32p, u32p, u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        lib.threefry_bits.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, u32p]
        lib.lwe_expand_seeded.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, u32p, u32p,
            ctypes.c_int32, ctypes.c_int32]
        lib.lwe_encrypt_seeded.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, u32p, u32p,
            ctypes.c_double, u32p, ctypes.c_int32, ctypes.c_int32, u32p]
        lib.lwe_encrypt_message_batch.argtypes = [
            ctypes.c_uint64, u32p, u32p, ctypes.c_int32, ctypes.c_double,
            u32p, ctypes.c_int32, ctypes.c_int32]
        lib.lwe_decrypt_message_batch.argtypes = [
            u32p, u32p, ctypes.c_int32, u32p, ctypes.c_int32, ctypes.c_int32]
        lib.trlwe_encrypt_batch.argtypes = [
            ctypes.c_uint64, u32p, u32p, ctypes.c_double, u32p,
            ctypes.c_int32, ctypes.c_int32]
        lib.trlwe_phase_batch.argtypes = [
            u32p, u32p, u32p, ctypes.c_int32, ctypes.c_int32]
        lib.trlwe_sample_extract.argtypes = [
            u32p, u32p, ctypes.c_int32, ctypes.c_int32]
        lib.circuit_levelize.argtypes = [i32p] * 5 + [ctypes.c_int32] * 3 + [i32p]
        lib.circuit_levelize.restype = ctypes.c_int32
        lib.circuit_plan.argtypes = (
            [i32p] * 5 + [ctypes.c_int32] * 3 + [i32p] * 5 + [ctypes.c_int32]
        )
        lib.circuit_plan.restype = ctypes.c_int32
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _u32(a):
    return np.ascontiguousarray(a, dtype=np.uint32)


def _ptr(a, typ=ctypes.c_uint32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def negacyclic_polymul(a, b) -> np.ndarray:
    """Exact u32 negacyclic product (client-side; server path uses int8 matmuls on the device)."""
    a, b = _u32(a), _u32(b)
    n = a.shape[-1]
    out = np.empty(n, dtype=np.uint32)
    _load().negacyclic_polymul_u32(_ptr(a), _ptr(b), _ptr(out), n)
    return out


def monomial_rotate(t, k: int) -> np.ndarray:
    t = _u32(t)
    n = t.shape[-1]
    out = np.empty(n, dtype=np.uint32)
    _load().negacyclic_monomial_rotate_u32(_ptr(t), _ptr(out), n, int(k))
    return out


def lwe_encrypt(seed: int, s, mu, alpha: float) -> np.ndarray:
    """Encrypt a batch of torus messages; returns uint32 [batch, n+1]."""
    s, mu = _u32(s), np.atleast_1d(_u32(mu))
    n, batch = s.shape[0], mu.shape[0]
    out = np.empty((batch, n + 1), dtype=np.uint32)
    _load().lwe_encrypt_batch(seed, _ptr(s), _ptr(mu), alpha, _ptr(out), batch, n)
    return out


def lwe_phase(ct, s) -> np.ndarray:
    ct, s = _u32(ct), _u32(s)
    ct2 = np.atleast_2d(ct)
    out = np.empty(ct2.shape[0], dtype=np.uint32)
    _load().lwe_phase_batch(_ptr(ct2), _ptr(s), _ptr(out), ct2.shape[0], s.shape[0])
    return out if ct.ndim > 1 else out[0]


def lwe_decrypt_bool(ct, s) -> np.ndarray:
    ct, s = _u32(ct), _u32(s)
    ct2 = np.atleast_2d(ct)
    out = np.empty(ct2.shape[0], dtype=np.uint8)
    _load().lwe_decrypt_bool_batch(
        _ptr(ct2), _ptr(s), _ptr(out, ctypes.c_uint8), ct2.shape[0], s.shape[0]
    )
    res = out.astype(bool)
    return res if ct.ndim > 1 else res[0]


def threefry_bits(k1: int, k2: int, start: int, count: int) -> np.ndarray:
    """JAX-bit-identical threefry2x32 stream (seeded-ciphertext masks)."""
    out = np.empty(count, dtype=np.uint32)
    _load().threefry_bits(k1, k2, start, count, _ptr(out))
    return out


def lwe_expand_seeded(seed, bodies, n: int) -> np.ndarray:
    """(seed uint32 [2], bodies uint32 [B]) -> full LWE batch [B, n+1]."""
    seed, bodies = _u32(seed), np.atleast_1d(_u32(bodies))
    out = np.empty((bodies.shape[0], n + 1), dtype=np.uint32)
    _load().lwe_expand_seeded(int(seed[0]), int(seed[1]), _ptr(bodies),
                              _ptr(out), bodies.shape[0], n)
    return out


def lwe_encrypt_seeded(seed, noise_seed: int, s, mu, alpha: float) -> np.ndarray:
    """Seeded (compressed) client encryption: masks re-derivable from the
    2-word threefry seed, so only bodies travel. Returns uint32 [B]."""
    seed, s, mu = _u32(seed), _u32(s), np.atleast_1d(_u32(mu))
    n, batch = s.shape[0], mu.shape[0]
    bodies = np.empty(batch, dtype=np.uint32)
    scratch = np.empty(n, dtype=np.uint32)
    _load().lwe_encrypt_seeded(int(seed[0]), int(seed[1]), noise_seed,
                               _ptr(s), _ptr(mu), alpha, _ptr(bodies),
                               batch, n, _ptr(scratch))
    return bodies


def lwe_encrypt_message(
    seed: int, s, msg, message_modulus: int, alpha: float
) -> np.ndarray:
    """Multi-value LWE messages at msg/(2*modulus) (reference tlwe.rs:84-98);
    returns uint32 [batch, n+1]."""
    s, msg = _u32(s), np.atleast_1d(_u32(msg))
    n, batch = s.shape[0], msg.shape[0]
    out = np.empty((batch, n + 1), dtype=np.uint32)
    _load().lwe_encrypt_message_batch(
        seed, _ptr(s), _ptr(msg), message_modulus, alpha, _ptr(out), batch, n
    )
    return out


def lwe_decrypt_message(ct, s, message_modulus: int) -> np.ndarray:
    """Round the phase to the nearest message (reference tlwe.rs:111-126)."""
    ct, s = _u32(ct), _u32(s)
    ct2 = np.atleast_2d(ct)
    out = np.empty(ct2.shape[0], dtype=np.uint32)
    _load().lwe_decrypt_message_batch(
        _ptr(ct2), _ptr(s), message_modulus, _ptr(out), ct2.shape[0],
        s.shape[0],
    )
    return out if ct.ndim > 1 else out[0]


def trlwe_encrypt(seed: int, s1, mu, alpha: float) -> np.ndarray:
    """Encrypt torus polynomials: mu uint32 [batch, N] (or [N]); returns
    uint32 [batch, 2, N] (mask, body) — reference trlwe.rs:30-52."""
    s1 = _u32(s1)
    mu = _u32(mu)
    mu2 = np.atleast_2d(mu)
    n, batch = s1.shape[0], mu2.shape[0]
    out = np.empty((batch, 2, n), dtype=np.uint32)
    _load().trlwe_encrypt_batch(seed, _ptr(s1), _ptr(mu2), alpha, _ptr(out),
                                batch, n)
    return out if mu.ndim > 1 else out[0]


def trlwe_phase(ct, s1) -> np.ndarray:
    """b - a (*) s per ciphertext: uint32 [batch, N]."""
    ct, s1 = _u32(ct), _u32(s1)
    ct3 = ct.reshape(-1, 2, s1.shape[0])
    out = np.empty((ct3.shape[0], s1.shape[0]), dtype=np.uint32)
    _load().trlwe_phase_batch(_ptr(ct3), _ptr(s1), _ptr(out), ct3.shape[0],
                              s1.shape[0])
    return out.reshape(ct.shape[:-2] + (s1.shape[0],))


def trlwe_sample_extract(ct, k: int = 0) -> np.ndarray:
    """TRLWE [2, N] -> lv1 LWE [N+1] extracting coefficient k (exact
    negation; reference trlwe.rs:106-120)."""
    ct = _u32(ct)
    n = ct.shape[-1]
    out = np.empty(n + 1, dtype=np.uint32)
    _load().trlwe_sample_extract(_ptr(ct), _ptr(out), n, int(k))
    return out


def gadget_decompose(x, l: int, bgbit: int, offset: int) -> np.ndarray:
    """x: uint32 [...]; returns int32 [l, ...] signed digits."""
    x = _u32(x)
    digits = np.empty((l, *x.shape), dtype=np.int32)
    _load().gadget_decompose_batch(
        _ptr(x), _ptr(digits, ctypes.c_int32), x.size, l, bgbit,
        np.uint32(offset & 0xFFFFFFFF),
    )
    return digits


def identity_key_switch(ct_lv1, ksk, n0: int, t: int, basebit: int) -> np.ndarray:
    """ct_lv1: uint32 [N+1]; ksk: uint32 [N, t, 2^basebit, n0+1]."""
    ct_lv1, ksk = _u32(ct_lv1), _u32(ksk)
    n1 = ct_lv1.shape[-1] - 1
    out = np.empty(n0 + 1, dtype=np.uint32)
    _load().identity_key_switch(_ptr(ct_lv1), _ptr(ksk), _ptr(out), n1, n0, t, basebit)
    return out
