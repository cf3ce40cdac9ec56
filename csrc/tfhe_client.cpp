// tfhe_client: native client-side runtime for rs_tfhe_tpu.
//
// The JAX server keeps the hot path (blind rotation / external products)
// on the accelerator; this library is the *client* counterpart —
// exact discretized-torus arithmetic for devices that encrypt, decrypt and
// pre/post-process ciphertexts without a JAX runtime. It fills the role the
// vendored SPQLIOS C++/assembly core plays in the reference
// (rs-tfhe src/fft/spqlios/fft_processor_spqlios.cpp): the native-code math
// kernel — but integer-exact (no FFT rounding) and with a batch-first C ABI
// consumed through ctypes (rs_tfhe_tpu/native/).
//
// Everything is plain C ABI, uint32 wrapping arithmetic (torus = Z/2^32,
// reference params.rs:40). Build: see csrc/Makefile.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// PRNG: xoshiro256** (public-domain algorithm) + SplitMix64 seeding.
// Distribution-equivalent to the reference's thread_rng usage (key.rs:34) —
// bit-compatibility with Rust rand is NOT a goal, determinism per seed is.
// ---------------------------------------------------------------------------

typedef struct {
  uint64_t s[4];
} rng_state;

static inline uint64_t splitmix64(uint64_t *x) {
  uint64_t z = (*x += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void rng_seed(rng_state *st, uint64_t seed) {
  for (int i = 0; i < 4; i++) st->s[i] = splitmix64(&seed);
}

static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

static inline uint64_t rng_next(rng_state *st) {
  uint64_t *s = st->s;
  const uint64_t result = rotl(s[1] * 5, 7) * 9;
  const uint64_t t = s[1] << 17;
  s[2] ^= s[0];
  s[3] ^= s[1];
  s[1] ^= s[2];
  s[0] ^= s[3];
  s[2] ^= t;
  s[3] = rotl(s[3], 45);
  return result;
}

static inline uint32_t rng_u32(rng_state *st) {
  return (uint32_t)(rng_next(st) >> 32);
}

// N(0,1) via Box-Muller (matches the reference's gaussian sampling in
// distribution, utils.rs:22-48).
static inline double rng_normal(rng_state *st) {
  double u1, u2;
  do {
    u1 = (double)(rng_next(st) >> 11) * (1.0 / 9007199254740992.0);
  } while (u1 <= 0.0);
  u2 = (double)(rng_next(st) >> 11) * (1.0 / 9007199254740992.0);
  return sqrt(-2.0 * log(u1)) * cos(6.283185307179586 * u2);
}

// gaussian torus noise: trunc(N(0, alpha) * 2^32) as u32 (utils.rs:31-38)
static inline uint32_t gaussian_torus(rng_state *st, double alpha) {
  double v = rng_normal(st) * alpha * 4294967296.0;
  return (uint32_t)(int64_t)v;
}

// ---------------------------------------------------------------------------
// Exact negacyclic polynomial arithmetic in Z_{2^32}[X]/(X^N + 1)
// ---------------------------------------------------------------------------

// out = a (*) b, wrapping uint32, any N. Blocked schoolbook over the signed
// 2N extension; exact (the reference's FFT path carries +/-1 ulp,
// fft/mod.rs:136-159).
void negacyclic_polymul_u32(const uint32_t *a, const uint32_t *b,
                            uint32_t *out, int32_t n) {
  memset(out, 0, sizeof(uint32_t) * (size_t)n);
  for (int32_t i = 0; i < n; i++) {
    const uint32_t ai = a[i];
    if (ai == 0) continue;
    for (int32_t j = 0; j < n - i; j++) out[i + j] += ai * b[j];       // i+j <  n
    for (int32_t j = n - i; j < n; j++) out[i + j - n] -= ai * b[j];   // i+j >= n
  }
}

// out = t * X^k (negacyclic monomial rotation, k in [0, 2N));
// reference trgsw.rs:307-330 with exact negation.
void negacyclic_monomial_rotate_u32(const uint32_t *t, uint32_t *out,
                                    int32_t n, int32_t k) {
  k = ((k % (2 * n)) + 2 * n) % (2 * n);
  for (int32_t c = 0; c < n; c++) {
    int32_t idx = c - k;
    // reduce into [0, 2N)
    idx = ((idx % (2 * n)) + 2 * n) % (2 * n);
    out[c] = idx < n ? t[idx] : (uint32_t)0 - t[idx - n];
  }
}

// ---------------------------------------------------------------------------
// LWE client operations (reference tlwe.rs)
// ---------------------------------------------------------------------------

// Encrypt `batch` torus messages under binary key s[n]: out rows are
// [a_0..a_{n-1}, b] with b = mu + gaussian(alpha) + <a, s>  (tlwe.rs:37-53).
void lwe_encrypt_batch(uint64_t seed, const uint32_t *s, const uint32_t *mu,
                       double alpha, uint32_t *out, int32_t batch, int32_t n) {
  rng_state st;
  rng_seed(&st, seed);
  for (int32_t r = 0; r < batch; r++) {
    uint32_t *row = out + (size_t)r * (n + 1);
    uint32_t dot = 0;
    for (int32_t i = 0; i < n; i++) {
      row[i] = rng_u32(&st);
      dot += row[i] * s[i];
    }
    row[n] = mu[r] + gaussian_torus(&st, alpha) + dot;
  }
}

// phase[r] = b - <a, s>   (tlwe.rs:60-68)
void lwe_phase_batch(const uint32_t *ct, const uint32_t *s, uint32_t *phase,
                     int32_t batch, int32_t n) {
  for (int32_t r = 0; r < batch; r++) {
    const uint32_t *row = ct + (size_t)r * (n + 1);
    uint32_t dot = 0;
    for (int32_t i = 0; i < n; i++) dot += row[i] * s[i];
    phase[r] = row[n] - dot;
  }
}

// bool decryption: sign test on the phase (tlwe.rs:60-68)
void lwe_decrypt_bool_batch(const uint32_t *ct, const uint32_t *s,
                            uint8_t *msg, int32_t batch, int32_t n) {
  for (int32_t r = 0; r < batch; r++) {
    const uint32_t *row = ct + (size_t)r * (n + 1);
    uint32_t dot = 0;
    for (int32_t i = 0; i < n; i++) dot += row[i] * s[i];
    msg[r] = (int32_t)(row[n] - dot) >= 0 ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Gadget decomposition (reference trgsw.rs:144-171) — batch of torus vectors
// into l signed base-2^bgbit digits with the rounding offset.
// ---------------------------------------------------------------------------

void gadget_decompose_batch(const uint32_t *x, int32_t *digits, int32_t count,
                            int32_t l, int32_t bgbit, uint32_t offset) {
  const uint32_t mask = (1u << bgbit) - 1;
  const int32_t half = 1 << (bgbit - 1);
  for (int32_t i = 0; i < count; i++) {
    const uint32_t t = x[i] + offset;
    for (int32_t d = 0; d < l; d++) {
      const uint32_t shift = 32 - (uint32_t)(d + 1) * (uint32_t)bgbit;
      digits[(size_t)d * count + i] = (int32_t)((t >> shift) & mask) - half;
    }
  }
}

// ---------------------------------------------------------------------------
// Identity key switching lv1 -> lv0 (reference trgsw.rs:332-360): digit
// decompose each of the N mask coefficients and subtract the selected KSK
// rows. ksk layout: [n1, t, base, n0+1] row-major; k = 0 rows are zero.
// ---------------------------------------------------------------------------

void identity_key_switch(const uint32_t *ct_lv1, const uint32_t *ksk,
                         uint32_t *out, int32_t n1, int32_t n0, int32_t t,
                         int32_t basebit) {
  const int32_t base = 1 << basebit;
  const uint32_t prec_offset = 1u << (32 - (1 + basebit * t));
  memset(out, 0, sizeof(uint32_t) * (size_t)(n0 + 1));
  out[n0] = ct_lv1[n1];
  for (int32_t i = 0; i < n1; i++) {
    const uint32_t abar = ct_lv1[i] + prec_offset;
    for (int32_t j = 0; j < t; j++) {
      const uint32_t k = (abar >> (32 - (j + 1) * basebit)) & (uint32_t)(base - 1);
      if (k == 0) continue;
      const uint32_t *row =
          ksk + (((size_t)i * t + j) * base + k) * (size_t)(n0 + 1);
      for (int32_t c = 0; c <= n0; c++) out[c] -= row[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Threefry-2x32 counter PRNG (Salmon et al., Random123), matching JAX's
// default partitionable PRNG bit-for-bit: per-element counter = (0, idx),
// output = x1 ^ x2 after 5 x 4 rounds (rs_tfhe_tpu/torus.py
// threefry2x32_bits_raw, verified cross-runtime in tests/test_native.py).
// This is the mask stream of SEEDED ciphertexts: the client and the JAX
// server re-derive identical masks from a 2-word seed.
// ---------------------------------------------------------------------------

static const int kThreefryRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};

void threefry_bits(uint32_t k1, uint32_t k2, uint32_t start, uint32_t count,
                   uint32_t *out) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k1, k2, k3};
  for (uint32_t i = 0; i < count; i++) {
    uint32_t x1 = ks[0];
    uint32_t x2 = start + i + ks[1];
    for (int round = 0; round < 5; round++) {
      for (int j = 0; j < 4; j++) {
        const int r = kThreefryRot[round % 2][j];
        x1 += x2;
        x2 = (x2 << r) | (x2 >> (32 - r));
        x2 ^= x1;
      }
      x1 += ks[(round + 1) % 3];
      x2 += ks[(round + 2) % 3] + (uint32_t)(round + 1);
    }
    out[i] = x1 ^ x2;
  }
}

// Expand seeded ciphertexts (seed + bodies) to full [batch, n+1] rows:
// mask row r = threefry_bits(seed, r*n, n).
void lwe_expand_seeded(uint32_t k1, uint32_t k2, const uint32_t *bodies,
                       uint32_t *out, int32_t batch, int32_t n) {
  for (int32_t r = 0; r < batch; r++) {
    uint32_t *row = out + (size_t)r * (n + 1);
    threefry_bits(k1, k2, (uint32_t)r * (uint32_t)n, (uint32_t)n, row);
    row[n] = bodies[r];
  }
}

// Seeded client encryption: masks from the threefry seed (so the server
// can expand), fresh gaussian noise from the xoshiro stream.
// bodies[r] = mu[r] + noise + <mask_r, s>.
void lwe_encrypt_seeded(uint32_t k1, uint32_t k2, uint64_t noise_seed,
                        const uint32_t *s, const uint32_t *mu, double alpha,
                        uint32_t *bodies, int32_t batch, int32_t n,
                        uint32_t *mask_scratch) {
  rng_state st;
  rng_seed(&st, noise_seed);
  for (int32_t r = 0; r < batch; r++) {
    threefry_bits(k1, k2, (uint32_t)r * (uint32_t)n, (uint32_t)n,
                  mask_scratch);
    uint32_t dot = 0;
    for (int32_t i = 0; i < n; i++) dot += mask_scratch[i] * s[i];
    bodies[r] = mu[r] + gaussian_torus(&st, alpha) + dot;
  }
}

// ---------------------------------------------------------------------------
// Multi-value message encoding (reference tlwe.rs:84-126): messages live at
// msg/(2*modulus) on the torus; decryption rounds the phase to the nearest
// message. The scale constant matches utils.rs:9-12 exactly
// (trunc(frac * 2^32) with truncation toward zero).
// ---------------------------------------------------------------------------

static inline uint32_t torus_scale(int32_t message_modulus) {
  double frac = fmod(1.0 / (2.0 * (double)message_modulus), 1.0);
  return (uint32_t)(int64_t)(frac * 4294967296.0);
}

void lwe_encrypt_message_batch(uint64_t seed, const uint32_t *s,
                               const uint32_t *msg, int32_t message_modulus,
                               double alpha, uint32_t *out, int32_t batch,
                               int32_t n) {
  const uint32_t scale = torus_scale(message_modulus);
  rng_state st;
  rng_seed(&st, seed);
  for (int32_t r = 0; r < batch; r++) {
    uint32_t *row = out + (size_t)r * (n + 1);
    uint32_t dot = 0;
    for (int32_t i = 0; i < n; i++) {
      row[i] = rng_u32(&st);
      dot += row[i] * s[i];
    }
    const uint32_t mu = (msg[r] % (uint32_t)message_modulus) * scale;
    row[n] = mu + gaussian_torus(&st, alpha) + dot;
  }
}

void lwe_decrypt_message_batch(const uint32_t *ct, const uint32_t *s,
                               int32_t message_modulus, uint32_t *msg,
                               int32_t batch, int32_t n) {
  const double scale = 1.0 / (2.0 * (double)message_modulus);
  for (int32_t r = 0; r < batch; r++) {
    const uint32_t *row = ct + (size_t)r * (n + 1);
    uint32_t dot = 0;
    for (int32_t i = 0; i < n; i++) dot += row[i] * s[i];
    const double phase = (double)(row[n] - dot) / 4294967296.0;
    msg[r] =
        (uint32_t)((int64_t)(phase / scale + 0.5) % (int64_t)message_modulus);
  }
}

// ---------------------------------------------------------------------------
// TRLWE client operations (reference trlwe.rs:30-81): ring-LWE ciphertexts
// [2, N] (mask polynomial a, body b = mu + noise + a (*) s). The mask-key
// product runs through the exact negacyclic schoolbook above — zero rounding,
// same convention as the JAX path (trlwe.py).
// ---------------------------------------------------------------------------

void trlwe_encrypt_batch(uint64_t seed, const uint32_t *s1,
                         const uint32_t *mu, double alpha, uint32_t *out,
                         int32_t batch, int32_t n) {
  rng_state st;
  rng_seed(&st, seed);
  for (int32_t r = 0; r < batch; r++) {
    uint32_t *a = out + (size_t)r * 2 * n;
    uint32_t *b = a + n;
    for (int32_t i = 0; i < n; i++) a[i] = rng_u32(&st);
    negacyclic_polymul_u32(a, s1, b, n);
    const uint32_t *m = mu + (size_t)r * n;
    for (int32_t i = 0; i < n; i++)
      b[i] += m[i] + gaussian_torus(&st, alpha);
  }
}

void trlwe_phase_batch(const uint32_t *ct, const uint32_t *s1,
                       uint32_t *phase, int32_t batch, int32_t n) {
  for (int32_t r = 0; r < batch; r++) {
    const uint32_t *a = ct + (size_t)r * 2 * n;
    const uint32_t *b = a + n;
    uint32_t *p = phase + (size_t)r * n;
    negacyclic_polymul_u32(a, s1, p, n);
    for (int32_t i = 0; i < n; i++) p[i] = b[i] - p[i];
  }
}

// Sample extraction TRLWE -> lv1 LWE at coefficient k (reference
// trlwe.rs:106-120; exact negation replaces the reference's MAX - x):
// p[i] = a[(k - i) mod* 2N] with negacyclic sign, body = b[k].
void trlwe_sample_extract(const uint32_t *ct, uint32_t *out, int32_t n,
                          int32_t k) {
  const uint32_t *a = ct;
  const uint32_t *b = ct + n;
  for (int32_t i = 0; i < n; i++) {
    int32_t idx = ((k - i) % (2 * n) + 2 * n) % (2 * n);
    out[i] = idx < n ? a[idx] : (uint32_t)0 - a[idx - n];
  }
  out[n] = b[k];
}

}  // extern "C"
