/* Batched Keccak-f[1600] permutation, C implementation.
 *
 * Native runtime component for the host Fiat-Shamir layer: the Merlin/STROBE
 * transcript batch (utils/strobe.py) advances B sponge states in lockstep;
 * this kernel applies the permutation to all B states in one call
 * (states: B x 25 little-endian uint64 lanes, contiguous).
 *
 * Replaces the reference's per-proof `merlin`/`keccak` Rust crates
 * (reference Cargo.toml:16) on the host side of the TPU framework.
 */

#include <stdint.h>
#include <stddef.h>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static void f1600_one(uint64_t a[25]) {
    uint64_t b[5], t, d;
    for (int rnd = 0; rnd < 24; rnd++) {
        /* theta */
        for (int x = 0; x < 5; x++)
            b[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++) {
            d = b[(x + 4) % 5] ^ ROTL64(b[(x + 1) % 5], 1);
            for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
        }
        /* rho + pi */
        t = a[1];
        {
            static const int pi_dst[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                           8,  21, 24, 4,  15, 23, 19, 13,
                                           12, 2,  20, 14, 22, 9,  6,  1};
            static const int rho[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                        45, 55, 2,  14, 27, 41, 56, 8,
                                        25, 43, 62, 18, 39, 61, 20, 44};
            for (int i = 0; i < 24; i++) {
                uint64_t tmp = a[pi_dst[i]];
                a[pi_dst[i]] = ROTL64(t, rho[i]);
                t = tmp;
            }
        }
        /* chi */
        for (int y = 0; y < 25; y += 5) {
            uint64_t c0 = a[y], c1 = a[y + 1], c2 = a[y + 2], c3 = a[y + 3],
                     c4 = a[y + 4];
            a[y] = c0 ^ (~c1 & c2);
            a[y + 1] = c1 ^ (~c2 & c3);
            a[y + 2] = c2 ^ (~c3 & c4);
            a[y + 3] = c3 ^ (~c4 & c0);
            a[y + 4] = c4 ^ (~c0 & c1);
        }
        /* iota */
        a[0] ^= RC[rnd];
    }
}

void keccak_f1600_batch(uint64_t *states, long batch) {
    for (long i = 0; i < batch; i++) f1600_one(states + 25 * i);
}

/* ------------------------------------------------------------------------
 * Single-lane STROBE-128 sequential ops.
 *
 * The verifier's weight stage is inherently sequential (one sponge, one
 * draw per proof: reference src/range_proof.rs:845-894), so the
 * numpy-batched sponge gains nothing there and Python/ctypes call overhead
 * dominates.  These helpers run the whole sequence in one native call,
 * bit-exact with utils/strobe.py framing.
 * ------------------------------------------------------------------------ */

#define STROBE_R 166

typedef struct {
    uint8_t *st;     /* 200-byte state */
    int32_t pos;
    int32_t pos_begin;
} strobe1;

static void strobe_run_f(strobe1 *s) {
    uint64_t a[25];
    s->st[s->pos] ^= (uint8_t)s->pos_begin;
    s->st[s->pos + 1] ^= 0x04;
    s->st[STROBE_R + 1] ^= 0x80;
    for (int i = 0; i < 25; i++) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | s->st[8 * i + j];
        a[i] = v;
    }
    f1600_one(a);
    for (int i = 0; i < 25; i++)
        for (int j = 0; j < 8; j++) s->st[8 * i + j] = (uint8_t)(a[i] >> (8 * j));
    s->pos = 0;
    s->pos_begin = 0;
}

static void strobe_absorb(strobe1 *s, const uint8_t *data, long n) {
    for (long i = 0; i < n; i++) {
        s->st[s->pos++] ^= data[i];
        if (s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_squeeze(strobe1 *s, uint8_t *out, long n) {
    for (long i = 0; i < n; i++) {
        out[i] = s->st[s->pos];
        s->st[s->pos++] = 0;
        if (s->pos == STROBE_R) strobe_run_f(s);
    }
}

/* begin_op for flags without T; force_f set for C/K flags */
static void strobe_begin_op(strobe1 *s, uint8_t flags, int force_f) {
    uint8_t hdr[2];
    hdr[0] = (uint8_t)s->pos_begin;
    hdr[1] = flags;
    s->pos_begin = s->pos + 1;
    strobe_absorb(s, hdr, 2);
    if (force_f && s->pos != 0) strobe_run_f(s);
}

/* n_items Merlin append_message(label, item) calls in sequence:
 *   meta_ad(label); meta_ad(LE32(item_len), more); ad(item)
 * items: n_items * item_len contiguous bytes. */
void strobe_append_seq(uint8_t *state, int32_t *pos, int32_t *pos_begin,
                       const uint8_t *label, long label_len,
                       const uint8_t *items, long n_items, long item_len) {
    strobe1 s = {state, *pos, *pos_begin};
    uint8_t le32[4] = {(uint8_t)item_len, (uint8_t)(item_len >> 8),
                       (uint8_t)(item_len >> 16), (uint8_t)(item_len >> 24)};
    for (long i = 0; i < n_items; i++) {
        strobe_begin_op(&s, 0x12, 0);              /* meta_ad: M|A */
        strobe_absorb(&s, label, label_len);
        strobe_absorb(&s, le32, 4);                /* meta_ad(..., more) */
        strobe_begin_op(&s, 0x02, 0);              /* ad: A */
        strobe_absorb(&s, items + i * item_len, item_len);
    }
    *pos = s.pos;
    *pos_begin = s.pos_begin;
}

/* n_draws Merlin TranscriptRng::fill_bytes(draw_len) calls in sequence:
 *   meta_ad(LE32(draw_len)); prf(draw_len)
 * out: n_draws * draw_len bytes. */
void strobe_rng_draws(uint8_t *state, int32_t *pos, int32_t *pos_begin,
                      long n_draws, long draw_len, uint8_t *out) {
    strobe1 s = {state, *pos, *pos_begin};
    uint8_t le32[4] = {(uint8_t)draw_len, (uint8_t)(draw_len >> 8),
                       (uint8_t)(draw_len >> 16), (uint8_t)(draw_len >> 24)};
    for (long i = 0; i < n_draws; i++) {
        strobe_begin_op(&s, 0x12, 0);              /* meta_ad: M|A */
        strobe_absorb(&s, le32, 4);
        strobe_begin_op(&s, 0x07, 1);              /* prf: I|A|C, forces F */
        strobe_squeeze(&s, out + i * draw_len, draw_len);
    }
    *pos = s.pos;
    *pos_begin = s.pos_begin;
}
