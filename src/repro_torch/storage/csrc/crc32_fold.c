/* zlib's crc32 (the reflected polynomial 0xEDB88320, register
 * pre- and post-inverted) folded with carry-less multiplies.
 *
 * The method is Gopal et al., "Fast CRC Computation for Generic
 * Polynomials Using PCLMULQDQ Instruction" (Intel, 2009): a running
 * remainder held in 128-bit lanes is multiplied, in GF(2)[x], by
 * x^(D+32) and x^(D-32) mod P (D the distance in bits to the data it is
 * folded into) and XORed into that data, so the loop reads memory at the
 * rate the multiplier keeps up with; at the end the lanes fold into one,
 * 128 bits fold to 64 and to 32, and a Barrett reduction leaves the crc.
 * Every constant below is such a power, bit-reflected and shifted left
 * by one, as the reflected domain wants.
 *
 * Three bodies, chosen at run time from what the CPU reports:
 *   level 2: four 512-bit lanes (VPCLMULQDQ with AVX-512), 256 bytes an
 *            iteration, for inputs of 256 bytes and more;
 *   level 1: four 128-bit lanes (PCLMULQDQ, SSE4.1), 64 bytes an
 *            iteration, for inputs of 64 bytes and more;
 *   level 0: a byte table, for what is left and for other CPUs.
 * The bodies carry target attributes, so the file builds with no -m flag
 * and a CPU without the instructions never runs them.
 *
 * C entries:
 *   crc32_fold(buf, len, crc)        zlib.crc32(buf[:len], crc), at the
 *                                    best level this CPU has
 *   crc32_fold_at(level, buf, len, crc)  the same at a level no higher
 *                                    than ``level`` (tests hold each body)
 *   crc32_fold_level()               the best level: 0 means no fold
 */

#include <stddef.h>
#include <stdint.h>

static uint32_t table[256];
static int best_level;

/* The byte table's crc over p[0:n] from the running (inverted) state. */
static uint32_t crc32_bytes(uint32_t state, const unsigned char *p, size_t n)
{
    while (n--)
        state = table[(state ^ *p++) & 0xff] ^ (state >> 8);
    return state;
}

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>

#define FOLD_SSE __attribute__((target("pclmul,sse4.1")))
#define FOLD_AVX512 __attribute__((target("avx512f,vpclmulqdq,pclmul,sse4.1")))

/* {x^(D+32), x^(D-32)} mod P for each fold distance D, then x^64 for the
 * 64 -> 32 bit fold, then {P, floor(x^64 / P)} for the Barrett step. */
static const uint64_t K512[2] = {0x154442bd4, 0x1c6e41596};
static const uint64_t K2048[2] = {0x11542778a, 0x1322d1430};
static const uint64_t K128[2] = {0x1751997d0, 0x0ccaa009e};
static const uint64_t K64[2] = {0x163cd6124, 0};
static const uint64_t BARRETT[2] = {0x1db710641, 0x1f7011641};

FOLD_SSE static inline __m128i load16(const void *p)
{
    return _mm_loadu_si128((const __m128i *)p);
}

/* One lane carried D bits forward: x.lo * k.lo ^ x.hi * k.hi. */
FOLD_SSE static inline __m128i fold16(__m128i x, __m128i k)
{
    return _mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x00), _mm_clmulepi64_si128(x, k, 0x11));
}

/* Four consecutive 128-bit lanes into one, the rest of the input in
 * 16-byte steps, then down to 32 bits; the last len % 16 bytes by the
 * table. Returns the running state. */
FOLD_SSE static uint32_t finish(__m128i x1, __m128i x2, __m128i x3, __m128i x4,
                                const unsigned char *buf, size_t len)
{
    const __m128i k = load16(K128);
    const __m128i lo32 = _mm_setr_epi32(~0, 0, ~0, 0);
    x1 = _mm_xor_si128(fold16(x1, k), x2);
    x1 = _mm_xor_si128(fold16(x1, k), x3);
    x1 = _mm_xor_si128(fold16(x1, k), x4);
    for (; len >= 16; buf += 16, len -= 16)
        x1 = _mm_xor_si128(fold16(x1, k), load16(buf));
    /* 128 -> 64 bits: the low half times x^96, onto the high half */
    x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), _mm_clmulepi64_si128(x1, k, 0x10));
    /* 64 -> 32 bits */
    x2 = _mm_srli_si128(x1, 4);
    x1 = _mm_xor_si128(_mm_clmulepi64_si128(_mm_and_si128(x1, lo32), load16(K64), 0x00), x2);
    /* Barrett: the quotient by floor(x^64 / P), times P, off the remainder */
    const __m128i b = load16(BARRETT);
    x2 = _mm_clmulepi64_si128(_mm_and_si128(x1, lo32), b, 0x10);
    x2 = _mm_clmulepi64_si128(_mm_and_si128(x2, lo32), b, 0x00);
    x1 = _mm_xor_si128(x1, x2);
    return crc32_bytes((uint32_t)_mm_extract_epi32(x1, 1), buf, len);
}

/* len >= 64 */
FOLD_SSE static uint32_t crc32_sse(uint32_t state, const unsigned char *buf, size_t len)
{
    const __m128i k = load16(K512);
    __m128i x1 = _mm_xor_si128(load16(buf), _mm_cvtsi32_si128((int)state));
    __m128i x2 = load16(buf + 16), x3 = load16(buf + 32), x4 = load16(buf + 48);
    for (buf += 64, len -= 64; len >= 64; buf += 64, len -= 64) {
        x1 = _mm_xor_si128(fold16(x1, k), load16(buf));
        x2 = _mm_xor_si128(fold16(x2, k), load16(buf + 16));
        x3 = _mm_xor_si128(fold16(x3, k), load16(buf + 32));
        x4 = _mm_xor_si128(fold16(x4, k), load16(buf + 48));
    }
    return finish(x1, x2, x3, x4, buf, len);
}

/* A 512-bit lane carried D bits forward and XORed into y. */
FOLD_AVX512 static inline __m512i fold64(__m512i x, __m512i k, __m512i y)
{
    return _mm512_ternarylogic_epi64(_mm512_clmulepi64_epi128(x, k, 0x00),
                                     _mm512_clmulepi64_epi128(x, k, 0x11), y, 0x96);
}

/* len >= 256 */
FOLD_AVX512 static uint32_t crc32_avx512(uint32_t state, const unsigned char *buf, size_t len)
{
    const __m512i k4 = _mm512_broadcast_i32x4(_mm_loadu_si128((const __m128i *)K2048));
    const __m512i k1 = _mm512_broadcast_i32x4(_mm_loadu_si128((const __m128i *)K512));
    __m512i z0 = _mm512_xor_si512(
        _mm512_loadu_si512(buf),
        _mm512_inserti32x4(_mm512_setzero_si512(), _mm_cvtsi32_si128((int)state), 0));
    __m512i z1 = _mm512_loadu_si512(buf + 64);
    __m512i z2 = _mm512_loadu_si512(buf + 128);
    __m512i z3 = _mm512_loadu_si512(buf + 192);
    for (buf += 256, len -= 256; len >= 256; buf += 256, len -= 256) {
        z0 = fold64(z0, k4, _mm512_loadu_si512(buf));
        z1 = fold64(z1, k4, _mm512_loadu_si512(buf + 64));
        z2 = fold64(z2, k4, _mm512_loadu_si512(buf + 128));
        z3 = fold64(z3, k4, _mm512_loadu_si512(buf + 192));
    }
    z3 = fold64(fold64(fold64(z0, k1, z1), k1, z2), k1, z3);
    for (; len >= 64; buf += 64, len -= 64)
        z3 = fold64(z3, k1, _mm512_loadu_si512(buf));
    return finish(_mm512_extracti32x4_epi32(z3, 0), _mm512_extracti32x4_epi32(z3, 1),
                  _mm512_extracti32x4_epi32(z3, 2), _mm512_extracti32x4_epi32(z3, 3), buf, len);
}
#endif

__attribute__((constructor)) static void crc32_fold_init(void)
{
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int b = 0; b < 8; b++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        table[n] = c;
    }
#if defined(__x86_64__) || defined(__i386__)
    __builtin_cpu_init();
    if (__builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1")) {
        best_level = 1;
        if (__builtin_cpu_supports("avx512f") && __builtin_cpu_supports("vpclmulqdq"))
            best_level = 2;
    }
#endif
}

int crc32_fold_level(void)
{
    return best_level;
}

uint32_t crc32_fold_at(int level, const void *buf, size_t len, uint32_t crc)
{
    const unsigned char *p = (const unsigned char *)buf;
    uint32_t state = ~crc;
    if (level > best_level)
        level = best_level;
#if defined(__x86_64__) || defined(__i386__)
    if (level >= 2 && len >= 256)
        return ~crc32_avx512(state, p, len);
    if (level >= 1 && len >= 64)
        return ~crc32_sse(state, p, len);
#endif
    return ~crc32_bytes(state, p, len);
}

uint32_t crc32_fold(const void *buf, size_t len, uint32_t crc)
{
    return crc32_fold_at(best_level, buf, len, crc);
}
