"""Smoke run of the library on one NVIDIA GPU at production parameters.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --multichip  # four GPUs: the multi-device phase only

Phases (any failure exits non-zero; nothing falls back to the CPU):
  device       the default JAX device must be a GPU; prints its kind, count,
               name and power limit
  compile      lowers batch_gate("nand") at SECURITY_128_BIT_FAST for B=4096
               and B=1, prints memory_analysis() and how each int8
               contraction was lowered (a loop-fused contraction fails)
  golden       reruns the production stages pinned in
               tests/vectors/golden_production.npz: each decrypts, and is
               bit-exact unless its keys and ciphertexts were sampled
               differently from the capture's (a digest says which)
  crosscheck   the integer evaluation on identical inputs, GPU against this
               host's CPU device, at FAST, strict, UINT4 and NIBBLE widths
  gates        NAND at B=4096 and a 5-gate B=1 chain, FAST and strict,
               standard and multi-bit keys, decrypted; one timed pass each
  circuit      compile_circuit on the 32-bit ripple-carry adder at FAST
  alternatives RS_TFHE_DOT_IMPL=bf16 and step_impl="nussbaumer", bit-exact
               against the default path
The last line of standard output is one JSON object with the device.
Timings are one pass each, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def require(ok: bool, what: str) -> None:
    if not ok:
        fail(what)
    log(f"  [ok] {what}")


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# HLO inspection: how each integer contraction was lowered
# ---------------------------------------------------------------------------

_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*([a-z0-9]+\[[0-9,]*\])")
_OPERANDS = r"\((?:[a-z0-9]+\[[0-9,]*\]\S*\s+)?%?([\w.\-]+),\s*" \
            r"(?:[a-z0-9]+\[[0-9,]*\]\S*\s+)?%?([\w.\-]+)"


def _computations(hlo: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo.splitlines():
        if cur is None:
            m = _COMP_RE.match(line)
            if m and "=" not in line.split("(")[0]:
                cur = m.group(1)
                comps[cur] = []
        elif line.strip() == "}":
            cur = None
        else:
            comps[cur].append(line)
    return comps


def contraction_lowerings(hlo: str, dtype: str = "s8"
                          ) -> list[tuple[str, str, str]]:
    """[(lowering, lhs type, rhs type)] for every `dtype` contraction in an
    optimized HLO module: a cuBLAS or Pallas/Triton custom call, a fusion
    (the Triton GEMM emitter's, or a loop/input fusion that computes the dot
    elementwise), a reduction fusion (a matrix-vector product rewritten as
    multiply + reduce; its s8 operand types), or an unfused dot."""
    comps = _computations(hlo)
    types = {}
    for lines in comps.values():
        for line in lines:
            m = _DEF_RE.match(line)
            if m:
                types[m.group(1)] = m.group(2)

    def operand_types(line, op):
        m = re.search(r"\s" + re.escape(op) + _OPERANDS, line)
        if not m:
            return None
        return types.get(m.group(1), "?"), types.get(m.group(2), "?")

    def dots_in(name, seen=()):
        found = []
        for line in comps.get(name, []):
            ops = operand_types(line, "dot")
            if ops:
                found.append(ops)
            for callee in re.findall(r"(?:calls|to_apply)=%?([\w.\-]+)", line):
                if callee not in seen:
                    found += dots_in(callee, seen + (name,))
        return found

    fused = set()
    out = []
    for lines in comps.values():
        for line in lines:
            if re.search(r"\sfusion\(", line):
                callee = re.search(r"calls=%?([\w.\-]+)", line)
                if not callee:
                    continue
                fused.add(callee.group(1))
                kind = re.search(r"kind=(\w+)", line)
                bk = re.search(r'"kind":"([^"]+)"', line)
                label = bk.group(1) if bk else (kind.group(1) if kind else "?")
                dots = dots_in(callee.group(1))
                for lhs, rhs in dots:
                    out.append((f"fusion {label}", lhs, rhs))
                body = comps.get(callee.group(1), [])
                s8_params = [types[m.group(1)] for m in map(_DEF_RE.match, body)
                             if m and m.group(2).startswith(dtype)
                             and "parameter(" in m.string]
                if not dots and s8_params and any(" reduce(" in b
                                                  for b in body):
                    # XLA rewrites a matrix-VECTOR product as multiply +
                    # row reduction
                    out.append(("reduction fusion", s8_params[0],
                                s8_params[-1]))
            elif "custom-call(" in line:
                tgt = re.search(r'custom_call_target="([^"]+)"', line)
                ops = operand_types(line, "custom-call")
                if tgt and ops and any(k in tgt.group(1).lower()
                                       for k in ("gemm", "matmul", "triton")):
                    out.append((f"custom-call {tgt.group(1)}", *ops))
    for name, lines in comps.items():
        if name in fused:
            continue
        for line in lines:
            ops = operand_types(line, "dot")
            if ops:
                out.append(("unfused dot", *ops))
    return [o for o in out if o[1].startswith(dtype) or o[2].startswith(dtype)]


def is_loop_lowering(lowering: str) -> bool:
    """A dot XLA emits as a plain loop rather than a GEMM."""
    return lowering in ("unfused dot", "fusion kLoop", "fusion kInput")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(expect: int) -> tuple[str, int]:
    log("== device")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX's default device is {devs[0].platform!r}")
    if len(devs) < expect:
        fail(f"need {expect} GPUs, JAX sees {len(devs)}")
    log(f"  device_kind={devs[0].device_kind} count={len(devs)}")
    log(f"  nvidia-smi: {gpu_name_and_limit()}")
    return devs[0].device_kind, len(devs)


def encrypt_bits(sk, bits, seed):
    from rs_tfhe_tpu.tlwe import lwe_encrypt_bool

    return lwe_encrypt_bool(jax.random.key(seed), sk.lv0, jnp.asarray(bits),
                            sk.params.tlwe_lv0.alpha)


def decrypt_bits(sk, ct):
    from rs_tfhe_tpu.tlwe import lwe_decrypt_bool

    return np.asarray(jax.device_get(lwe_decrypt_bool(ct, sk.lv0)))


def make_keys(params, multibit=False):
    from rs_tfhe_tpu.key import CloudKey, SecretKey

    sk = SecretKey.generate(jax.random.key(42), params)
    ck = CloudKey.generate(jax.random.key(7), sk, multibit=multibit)
    return sk, jax.block_until_ready(ck)


def phase_compile(ck, card: str) -> None:
    """How XLA lowers batch_gate("nand")'s int8 contractions at FAST. At
    B=4096 each must be a GEMM (cuBLAS or a Triton GEMM fusion); at B=1 a
    [1, K] x [K, M] product may also be a reduction fusion (XLA's
    matrix-vector form). A dot emitted as a loop fails."""
    from rs_tfhe_tpu import gates
    from rs_tfhe_tpu.config import config

    log("== compile (SECURITY_128_BIT_FAST, batch_gate nand)")
    p = ck.params
    k_step = 2 * p.trgsw_lv1.l * p.n1
    k_ks = p.n1 * p.trgsw_lv1.iks_t * p.ks_base
    for batch in (4096, 1):
        a = jax.ShapeDtypeStruct((batch, p.n0 + 1), jnp.uint32)
        t0 = time.perf_counter()
        compiled = gates._gate2.lower("nand", a, a, ck, config.step_impl).compile()
        log(f"  B={batch}: compiled in {time.perf_counter() - t0:.1f} s")
        log(f"  B={batch} memory_analysis: {compiled.memory_analysis()}")
        hlo = compiled.as_text()
        lowered = contraction_lowerings(hlo)
        require(bool(lowered), f"B={batch}: found the int8 contractions")
        for how, lhs, rhs in sorted(set(lowered)):
            k = int(re.findall(r"\d+", lhs.split("[")[1])[-1])
            role = ("blind-rotation step" if k == k_step
                    else "key-switch one-hot" if k == k_ks
                    else "matrix-vector" if how == "reduction fusion"
                    else "other")
            log(f"  B={batch} {role}: {lhs} x {rhs} -> {how}")
            ok = not is_loop_lowering(how) and (
                batch == 1 or how != "reduction fusion")
            require(ok, f"B={batch} {role} contraction is a GEMM"
                    + (" or a matrix-vector reduction" if batch == 1 else ""))
        # the lhs is never broadcast over the 8 (poly, limb) pairs
        f_rows = batch * p.digit_limbs
        bcast = re.findall(r"s8\[(?:2,4|8),%d,%d\]" % (f_rows, k_step), hlo)
        require(not bcast, f"B={batch}: no [8, F, 2L*N] broadcast lhs")
    log(f"  ({card})")


def phase_golden(card: str) -> None:
    """Every stage must decrypt correctly. It must also be bit-exact with
    the capture, unless its group's sampled keys and ciphertexts (the only
    float arithmetic) differ from the capture's: then the difference entered
    in noise sampling, and the crosscheck phase holds the integer
    evaluation to the CPU's bit for bit."""
    from rs_tfhe_tpu.utils import golden

    log("== golden (tests/vectors/golden_production.npz)")
    stored = np.load(golden.GOLDEN_PATH)
    want = sorted([*golden.STAGES, *map(golden.digest_key, golden.GROUPS)])
    require(sorted(stored.files) == want, f"golden file holds {want}")
    for group, run in golden.GROUPS.items():
        t0 = time.perf_counter()
        sampled, stages = run()
        log(f"  group {group}: {time.perf_counter() - t0:.1f} s incl. keygen "
            f"and compile ({card})")
        same_inputs = np.array_equal(stored[golden.digest_key(group)], sampled)
        log(f"  group {group}: sampled keys and ciphertexts "
            f"{'identical to' if same_inputs else 'DIFFER from'} the capture's")
        for st in stages:
            require(st.correct, f"{st.name}: decrypts to the plain result")
            same = np.array_equal(stored[st.name], st.out)
            log(f"  {st.name}: {'bit-exact' if same else 'DIFFERS'} vs the "
                f"stored capture")
            if same_inputs:
                require(same, f"{st.name} bit-exact on identical inputs")


def phase_crosscheck() -> None:
    """The integer evaluation on identical inputs, GPU against the same
    jitted functions on this host's CPU device: a gate bootstrap at FAST,
    strict and UINT4 (3-limb digits), and at NIBBLE (N=4096) an 8-step
    blind rotation with sample extract plus a key switch."""
    import dataclasses

    from rs_tfhe_tpu import (
        SECURITY_128_BIT, SECURITY_128_BIT_FAST, SECURITY_128_BIT_NIBBLE,
        SECURITY_UINT4,
    )
    from rs_tfhe_tpu.bootstrap import bootstrap
    from rs_tfhe_tpu.ops.blind_rotate import blind_rotate
    from rs_tfhe_tpu.ops.extract import sample_extract
    from rs_tfhe_tpu.ops.keyswitch import identity_key_switch

    log("== crosscheck (GPU vs this host's CPU device, identical inputs)")
    cpu = jax.devices("cpu")[0]

    def same_on_both(fn, *args):
        got = np.asarray(fn(*args))
        ref = np.asarray(fn(*jax.device_put(args, cpu)))
        return np.array_equal(got, ref)

    boot = jax.jit(bootstrap)
    for params in (SECURITY_128_BIT_FAST, SECURITY_128_BIT, SECURITY_UINT4):
        sk, ck = make_keys(params)
        ct = encrypt_bits(sk, np.array([True, False]), 3)
        require(same_on_both(boot, ct, ck),
                f"{params.description}: bootstrap B=2 GPU == CPU bit-exact")

    pn = SECURITY_128_BIT_NIBBLE
    sk, ck = make_keys(pn)
    rng = np.random.default_rng(3)
    steps = 8
    p8 = dataclasses.replace(
        pn, tlwe_lv0=dataclasses.replace(pn.tlwe_lv0, n=steps))
    ct = jnp.asarray(rng.integers(0, 1 << 32, (2, steps + 1), dtype=np.uint32))
    rot = jax.jit(lambda ct, tv, bsk: sample_extract(
        blind_rotate(ct, tv, bsk, p8), 0))
    require(same_on_both(rot, ct, ck.testvec, ck.bsk[:steps]),
            f"NIBBLE: {steps}-step blind rotation + extract GPU == CPU")
    lv1 = jnp.asarray(rng.integers(0, 1 << 32, (2, pn.n1 + 1), dtype=np.uint32))
    ks = jax.jit(lambda x, k: identity_key_switch(x, k, pn))
    require(same_on_both(ks, lv1, ck.ksk_limbs),
            "NIBBLE: key switch GPU == CPU bit-exact")


def _chain(n):
    """n NAND gates in one jit, each consuming the previous output; a loop,
    so the gate compiles once."""
    from rs_tfhe_tpu.gates import batch_gate

    @jax.jit
    def chain(x, y, ck):
        return jax.lax.fori_loop(
            0, n, lambda _, x: batch_gate("nand", x, y, ck), x)

    return chain


def phase_gates(card: str) -> None:
    from rs_tfhe_tpu import SECURITY_128_BIT, SECURITY_128_BIT_FAST
    from rs_tfhe_tpu.gates import batch_gate

    log("== gates (one timed pass each; a smoke run, not a benchmark)")
    rng = np.random.default_rng(0)
    chain5 = _chain(5)
    for params in (SECURITY_128_BIT_FAST, SECURITY_128_BIT):
        for multibit in (False, True):
            sk, ck = make_keys(params, multibit)
            tag = f"{params.description}, {'multi-bit' if multibit else 'standard'} key"
            bits_a = rng.integers(0, 2, 4096).astype(bool)
            bits_b = rng.integers(0, 2, 4096).astype(bool)
            a, b = encrypt_bits(sk, bits_a, 1), encrypt_bits(sk, bits_b, 2)
            jax.block_until_ready(batch_gate("nand", a, b, ck))  # compile
            t0 = time.perf_counter()
            out = jax.block_until_ready(batch_gate("nand", a, b, ck))
            dt = time.perf_counter() - t0
            require((decrypt_bits(sk, out) == ~(bits_a & bits_b)).all(),
                    f"{tag}: NAND B=4096 decrypts")
            log(f"  {tag}: NAND B=4096 one pass {dt * 1e3:.1f} ms "
                f"({4096 / dt:.0f} gates/s; {card})")
            x, y = a[:1], b[:1]
            jax.block_until_ready(chain5(x, y, ck))  # compile
            t0 = time.perf_counter()
            out = jax.block_until_ready(chain5(x, y, ck))
            dt = time.perf_counter() - t0
            want = bits_a[0]
            for _ in range(5):
                want = not (want and bits_b[0])
            require(bool(decrypt_bits(sk, out)[0]) == want,
                    f"{tag}: 5-gate B=1 NAND chain decrypts")
            log(f"  {tag}: 5-gate B=1 chain one pass {dt * 1e3:.1f} ms "
                f"({dt * 1e3 / 5:.2f} ms/gate; {card})")


def phase_circuit(card: str) -> None:
    from rs_tfhe_tpu import SECURITY_128_BIT_FAST
    from rs_tfhe_tpu.bit_utils import decrypt_uint, encrypt_uint
    from rs_tfhe_tpu.models import netlist

    log("== circuit (compile_circuit, 32-bit ripple-carry adder, FAST)")
    sk, ck = make_keys(SECURITY_128_BIT_FAST)
    ckt, _, _, sums = netlist.ripple_carry_adder(32)
    x, y = 3_141_592_653, 2_718_281_828
    alpha = sk.params.tlwe_lv0.alpha
    inputs = jnp.concatenate([
        encrypt_uint(jax.random.key(8), sk.lv0, x, 32, alpha),
        encrypt_uint(jax.random.key(9), sk.lv0, y, 32, alpha),
    ], axis=0)
    run = netlist.compile_circuit(ckt)
    t0 = time.perf_counter()
    jax.block_until_ready(run(inputs, ck))
    log(f"  compile + first run {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wires = jax.block_until_ready(run(inputs, ck))
    log(f"  one pass {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
    got = decrypt_uint(wires[jnp.asarray(sums)], sk.lv0)
    require(int(got) == (x + y) % (1 << 32), "32-bit adder decrypts to x + y")


def phase_alternatives() -> None:
    from rs_tfhe_tpu import SECURITY_128_BIT_FAST, gates
    from rs_tfhe_tpu.config import config
    from rs_tfhe_tpu.ops import poly

    log("== alternatives (bf16 dot_impl, nussbaumer step_impl)")
    p = SECURITY_128_BIT_FAST
    rng = np.random.default_rng(1)
    j = 2 * p.trgsw_lv1.l
    d = jnp.asarray(rng.integers(-128, 128, (4096, j, p.n1)), jnp.int32)
    t = jnp.asarray(rng.integers(0, 1 << 32, (j, 2, p.n1), dtype=np.uint32))

    def step(d, t):
        return poly.polymul_small_by_torus_multi(
            d, poly.build_step_matrix(t), 1, 2)

    ref = np.asarray(jax.jit(step)(d, t))
    old = config.dot_impl
    config.dot_impl = "bf16"
    try:
        got = np.asarray(jax.jit(step)(d, t))
    finally:
        config.dot_impl = old
    require(np.array_equal(got, ref),
            "bf16 step contraction == int8, FAST widths, B=4096")

    sk, ck = make_keys(p)
    bits = np.arange(8) % 2 == 0
    a, b = encrypt_bits(sk, bits, 1), encrypt_bits(sk, ~bits, 2)
    ref = np.asarray(gates.batch_gate("nand", a, b, ck))
    old = config.step_impl
    config.step_impl = "nussbaumer"
    try:
        got = np.asarray(gates.batch_gate("nand", a, b, ck))
        hlo = gates._gate2.lower("nand", a, b, ck, "nussbaumer").compile(
        ).as_text()
    finally:
        config.step_impl = old
    for how, lhs, rhs in sorted(set(contraction_lowerings(hlo, "s16"))):
        log(f"  nussbaumer B=8 int16 contraction: {lhs} x {rhs} -> {how}")
    require(np.array_equal(got, ref),
            "nussbaumer NAND == xla NAND bit-exact, FAST, B=8")


def phase_multichip(card: str) -> None:
    from rs_tfhe_tpu import SECURITY_128_BIT_FAST
    from rs_tfhe_tpu.gates import batch_gate
    from rs_tfhe_tpu.parallel import (
        data_parallel_gate, make_mesh, replicate, shard_batch,
        tensor_parallel_gate,
    )

    log("== multichip (4 devices)")
    sk, ck = make_keys(SECURITY_128_BIT_FAST)
    rng = np.random.default_rng(2)
    bits_a = rng.integers(0, 2, 4096).astype(bool)
    bits_b = rng.integers(0, 2, 4096).astype(bool)
    a, b = encrypt_bits(sk, bits_a, 1), encrypt_bits(sk, bits_b, 2)

    mesh = make_mesh(4)
    devs = set(jax.devices()[:4])
    sh = shard_batch(a, mesh)
    require({s.device for s in sh.addressable_shards} == devs
            and all(s.data.shape[0] == 1024 for s in sh.addressable_shards),
            "shard_batch puts 1024 rows on each of the 4 devices")
    rep = replicate(ck, mesh)
    require(all({s.device for s in leaf.addressable_shards} == devs
                for leaf in jax.tree_util.tree_leaves(rep)),
            "replicate puts every key array on all 4 devices")

    ref = np.asarray(batch_gate("nand", a, b, ck))
    require((decrypt_bits(sk, jnp.asarray(ref)) == ~(bits_a & bits_b)).all(),
            "one-device NAND 4x1024 decrypts")
    out = jax.block_until_ready(data_parallel_gate("nand", a, b, ck, mesh))
    t0 = time.perf_counter()
    out = jax.block_until_ready(data_parallel_gate("nand", a, b, ck, mesh))
    dt = time.perf_counter() - t0
    require(np.array_equal(np.asarray(out), ref),
            "data_parallel_gate 4x1024 == one device, bit-exact")
    log(f"  data parallel 4x1024 one pass {dt * 1e3:.1f} ms ({card})")

    mesh_tp = make_mesh(4, tp=4)
    ref4 = np.asarray(batch_gate("nand", a[:4], b[:4], ck))
    out = jax.block_until_ready(
        tensor_parallel_gate("nand", a[:4], b[:4], ck, mesh_tp))
    t0 = time.perf_counter()
    out = jax.block_until_ready(
        tensor_parallel_gate("nand", a[:4], b[:4], ck, mesh_tp))
    dt = time.perf_counter() - t0
    require(np.array_equal(np.asarray(out), ref4),
            "tensor_parallel_gate B=4 tp=4 == one device, bit-exact")
    log(f"  tensor parallel B=4 tp=4 one pass {dt * 1e3:.1f} ms ({card})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-GPU data/tensor-parallel phase")
    args = ap.parse_args()

    t_start = time.perf_counter()
    kind, count = phase_device(4 if args.multichip else 1)
    from rs_tfhe_tpu import SECURITY_128_BIT_FAST
    from rs_tfhe_tpu.utils.cache import enable_compile_cache

    log(f"  compile cache: {enable_compile_cache()}")
    card = gpu_name_and_limit().splitlines()[0]
    if args.multichip:
        phase_multichip(card)
    else:
        _, ck = make_keys(SECURITY_128_BIT_FAST)
        for phase in (lambda: phase_compile(ck, card),
                      lambda: phase_golden(card), phase_crosscheck,
                      lambda: phase_gates(card), lambda: phase_circuit(card),
                      phase_alternatives):
            phase()
            log(f"  (elapsed {time.perf_counter() - t_start:.0f} s)")
    log(f"== all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform, "kind": kind, "count": count}}),
        flush=True)


if __name__ == "__main__":
    main()
