"""Coverage for the exported surfaces review round 1 flagged as untested:
generate_lookup_table_full / _custom, Encoder.encode_with_scale,
make_multihost_mesh (under a real jax.distributed single-process init),
and utils/profiling (Timer.span, gate_throughput, trace)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from rs_tfhe_tpu import gates
from rs_tfhe_tpu.bootstrap import LutBootstrap
from rs_tfhe_tpu.lut.encoder import Encoder
from rs_tfhe_tpu.lut.generator import Generator
from rs_tfhe_tpu.tlwe import lwe_encrypt_bool, lwe_encrypt_message
from rs_tfhe_tpu.utils import profiling


def test_encode_with_scale_and_with_scale_ctor():
    enc = Encoder(8)
    custom = Encoder.with_scale(8, 1.0 / 32.0)
    m = np.arange(8)
    # explicit scale overrides the default 1/(2m)
    np.testing.assert_array_equal(
        enc.encode_with_scale(m, 1.0 / 32.0), custom.encode(m)
    )
    # default-scale path unchanged
    np.testing.assert_array_equal(
        enc.encode_with_scale(m, enc.scale), enc.encode(m)
    )
    # and decode inverts the custom encoder exactly on clean values
    np.testing.assert_array_equal(custom.decode(custom.encode(m)), m)


def test_generate_lookup_table_full_raw_torus(tiny):
    """_full takes raw Torus outputs (reference generator.rs:146-194): the
    plateau for message x must hold the raw value f(x), not encode(f(x))."""
    gen = Generator(4, tiny)
    raw = lambda x: np.uint32(x * 0x10000000 + 5)
    lut = gen.generate_lookup_table_full(raw)
    poly = np.asarray(lut.poly)
    assert poly.shape == (2, tiny.n1)
    assert (poly[0] == 0).all()  # trivial TRLWE: a = 0
    # center of message-0's plateau (after the rotate-by-offset the first
    # entries belong to x = 0)
    assert poly[1][0] == raw(0)
    values = set(np.unique(poly[1]).tolist())
    expect = set()
    for x in range(4):
        expect.add(int(raw(x)))
        expect.add(int((-np.int64(raw(x))) & 0xFFFFFFFF))  # negated tail
    assert values <= expect


def test_generate_lookup_table_custom_end_to_end(tiny, sk, ck):
    """_custom re-scales the encoder (reference generator.rs:205-224); a
    half-scale LUT decodes under the matching half-scale encoder."""
    modulus = 4
    scale = 1.0 / (4.0 * modulus)  # half the default
    gen = Generator(modulus, tiny)
    lut = gen.generate_lookup_table_custom(lambda x: (x + 1) % modulus, modulus, scale)
    msgs = jnp.asarray([0, 1, 2, 3], jnp.uint32)
    ct = lwe_encrypt_message(
        jax.random.key(5), sk.lv0, msgs, modulus, tiny.tlwe_lv0.alpha
    )
    out = LutBootstrap().bootstrap_lut(ct, lut, ck)
    from rs_tfhe_tpu.tlwe import lwe_phase

    phases = np.asarray(lwe_phase(out, sk.lv0))
    dec = Encoder.with_scale(modulus, scale).decode(phases)
    np.testing.assert_array_equal(dec, [1, 2, 3, 0])


def test_make_multihost_mesh_with_distributed_init():
    """make_multihost_mesh under an actual single-process
    jax.distributed.initialize() — run in a subprocess because distributed
    state is global and the virtual-device count must be set at startup."""
    code = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize("localhost:12355", num_processes=1, process_id=0)
from rs_tfhe_tpu.parallel.mesh import make_multihost_mesh, shard_batch, replicate
import jax.numpy as jnp
mesh = make_multihost_mesh(tp=2)
assert mesh.devices.size == 8, mesh
assert mesh.axis_names == ("batch", "model"), mesh.axis_names
x = shard_batch(jnp.arange(32.0).reshape(16, 2), mesh)
k = replicate({"k": jnp.ones((3,))}, mesh)
assert float(x.sum()) == 496.0
assert float(k["k"].sum()) == 3.0
print("MULTIHOST-OK", flush=True)
jax.distributed.shutdown()
"""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8",
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=env,
    )
    # judge by the success marker: distributed-service teardown can log
    # grpc noise after the work completed
    assert "MULTIHOST-OK" in res.stdout, (res.returncode, res.stderr[-2000:])


def test_profiling_timer_and_trace(tiny, sk, ck, tmp_path):
    t = profiling.Timer()
    bits = jnp.asarray([True, False])
    a = lwe_encrypt_bool(jax.random.key(1), sk.lv0, bits, tiny.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(2), sk.lv0, ~bits, tiny.tlwe_lv0.alpha)
    with profiling.trace(str(tmp_path / "trace")):
        with t.span("nand", sync_on=None):
            out = gates.nand(a, b, ck)
        profiling.force(out)
    rep = t.report()
    assert "nand" in rep
    gps = profiling.gate_throughput(
        lambda x, y, k: gates.nand(x, y, k), a, b, ck, iters=1
    )
    assert gps > 0


def test_generate_secure_keys_work(tiny):
    """SecretKey/CloudKey.generate_secure: OS-entropy-seeded production
    keygen (SECURITY.md). Two draws must differ, and the resulting key
    pair must evaluate a gate correctly."""
    from rs_tfhe_tpu.key import CloudKey, SecretKey

    sk1 = SecretKey.generate_secure(tiny)
    sk2 = SecretKey.generate_secure(tiny)
    assert not np.array_equal(np.asarray(sk1.lv0), np.asarray(sk2.lv0))
    ck1 = CloudKey.generate_secure(sk1)
    bits = jnp.asarray([True, False])
    a = lwe_encrypt_bool(jax.random.key(1), sk1.lv0, bits, tiny.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(jax.random.key(2), sk1.lv0, ~bits, tiny.tlwe_lv0.alpha)
    out = gates.nand(a, b, ck1)
    from rs_tfhe_tpu.tlwe import lwe_decrypt_bool

    assert np.array_equal(np.asarray(lwe_decrypt_bool(out, sk1.lv0)),
                          [True, True])
