// liquid-dsp-compatible bsequence C ABI — working native implementation.
//
// The reference ships this surface as an *unimplemented* skeleton
// (/root/reference/c_shim/src/lib.rs: every body is unimplemented!()).
// This is a complete C++ implementation with the same ABI so C callers of
// liquid's bsequence API can link against the framework's native layer.
// Semantics follow /root/reference/src/sequence/bsequence.rs (which follows
// liquid-dsp): bits packed into 32-bit words, pushed in from the right.
//
// Build: make -C native   (produces libyagi_native.so)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>

extern "C" {

struct bsequence_s {
    uint32_t *s;            // packed words, s[0] holds the MSB end
    unsigned int num_bits;
    unsigned int s_len;
    unsigned int num_bits_msb;
    uint32_t bit_mask_msb;
};

typedef struct bsequence_s *bsequence;

bsequence bsequence_create(unsigned int num_bits) {
    if (num_bits == 0) return nullptr;
    bsequence q = (bsequence)std::malloc(sizeof(struct bsequence_s));
    q->num_bits = num_bits;
    q->s_len = (num_bits + 31) / 32;
    q->num_bits_msb = (num_bits % 32 == 0) ? 32 : num_bits % 32;
    q->bit_mask_msb =
        (q->num_bits_msb >= 32) ? 0xFFFFFFFFu : ((1u << q->num_bits_msb) - 1u);
    q->s = (uint32_t *)std::calloc(q->s_len, sizeof(uint32_t));
    return q;
}

void bsequence_destroy(bsequence q) {
    if (!q) return;
    std::free(q->s);
    std::free(q);
}

void bsequence_reset(bsequence q) {
    std::memset(q->s, 0, q->s_len * sizeof(uint32_t));
}

void bsequence_push(bsequence q, unsigned int bit) {
    q->s[0] = (q->s[0] << 1) & q->bit_mask_msb;
    for (unsigned int i = 1; i < q->s_len; i++) {
        uint32_t overflow = (q->s[i] >> 31) & 1u;
        q->s[i] <<= 1;
        q->s[i - 1] |= overflow;
    }
    q->s[q->s_len - 1] |= (bit & 1u);
}

void bsequence_init(bsequence q, const unsigned char *v) {
    unsigned int k = 0;
    unsigned char byte = 0;
    unsigned char mask = 0x80;
    for (unsigned int i = 0; i < q->num_bits; i++) {
        if (i % 8 == 0) {
            byte = v[k++];
            mask = 0x80;
        }
        bsequence_push(q, (byte & mask) ? 1 : 0);
        mask >>= 1;
    }
}

void bsequence_circshift(bsequence q) {
    uint32_t msb_mask = 1u << (q->num_bits_msb - 1);
    uint32_t b = (q->s[0] & msb_mask) >> (q->num_bits_msb - 1);
    bsequence_push(q, b);
}

static unsigned int popcount32(uint32_t v) {
#if defined(__GNUC__)
    return (unsigned int)__builtin_popcount(v);
#else
    unsigned int c = 0;
    while (v) { c += v & 1u; v >>= 1; }
    return c;
#endif
}

int bsequence_correlate(bsequence a, bsequence b) {
    if (a->s_len != b->s_len) return -0x7FFFFFFF;
    int rxy = 0;
    for (unsigned int i = 0; i < a->s_len; i++)
        rxy += (int)popcount32(~(a->s[i] ^ b->s[i]));
    rxy -= 32 - (int)a->num_bits_msb;
    return rxy;
}

void bsequence_add(bsequence a, bsequence b, bsequence c) {
    for (unsigned int i = 0; i < a->s_len; i++) c->s[i] = a->s[i] ^ b->s[i];
}

void bsequence_mul(bsequence a, bsequence b, bsequence c) {
    for (unsigned int i = 0; i < a->s_len; i++) c->s[i] = a->s[i] & b->s[i];
}

unsigned int bsequence_accumulate(bsequence q) {
    unsigned int acc = 0;
    for (unsigned int i = 0; i < q->s_len; i++) acc += popcount32(q->s[i]);
    return acc;
}

unsigned int bsequence_get_length(bsequence q) { return q->num_bits; }

unsigned int bsequence_index(bsequence q, unsigned int i) {
    if (i >= q->num_bits) return 0;
    unsigned int k = q->s_len - 1 - i / 32;
    return (q->s[k] >> (i % 32)) & 1u;
}

void bsequence_print(bsequence q) {
    std::printf("<bsequence, bits=%u>\n", q->num_bits);
}

// complementary (Golay) code pair construction (bsequence.rs:34-79)
int bsequence_create_ccodes(bsequence a, bsequence b) {
    if (a->num_bits != b->num_bits) return -1;
    if (a->num_bits < 8 || a->num_bits % 8 != 0) return -1;
    unsigned int num_bytes = a->num_bits / 8;
    unsigned char *va = (unsigned char *)std::calloc(num_bytes, 1);
    unsigned char *vb = (unsigned char *)std::calloc(num_bytes, 1);
    va[num_bytes - 1] = 0xB8;
    vb[num_bytes - 1] = 0xB7;
    for (unsigned int n = 1; n < num_bytes; n *= 2) {
        unsigned int i_n1 = num_bytes - n;
        unsigned int i_n0 = num_bytes - 2 * n;
        unsigned char *tmp = (unsigned char *)std::malloc(n);
        std::memcpy(tmp, &va[i_n1], n);              // a tail
        std::memcpy(&va[i_n0], tmp, n);              // a -> [a b]
        std::memcpy(&vb[i_n0], tmp, n);              // b -> [a ~b]
        std::memcpy(&va[i_n1], &vb[i_n1], n);
        for (unsigned int i = 0; i < n; i++) vb[num_bytes - i - 1] ^= 0xFF;
        std::free(tmp);
    }
    bsequence_init(a, va);
    bsequence_init(b, vb);
    std::free(va);
    std::free(vb);
    return 0;
}

}  // extern "C"
