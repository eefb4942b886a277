/* The entropy stages of the media the server reads, for the host CPU:
 * JPEG Huffman decoding (baseline, extended sequential and progressive)
 * into quantized coefficient planes, and GIF LZW decoding into palette
 * indices. Everything after these two serial bit-level loops
 * (dequantization, the IDCT, upsampling, colour, palettes, compositing)
 * is numpy in engine/jpeg.py and engine/gif.py.
 *
 * Built on first use with the host C compiler into the package's _build
 * directory and called through ctypes (kernels.build_host), which
 * releases the interpreter lock for the call.
 *
 * The input is untrusted: every read is bounds-checked and every table is
 * validated. A function returns 0 or one of the LLMK_E_* codes below and
 * never reads or writes outside the buffers it was given.
 */
#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
#define LLMK_API extern "C"
#else
#define LLMK_API
#endif

#define LLMK_OK 0
#define LLMK_E_TRUNCATED -1      /* the data (or the scan's, at a marker) ends too soon */
#define LLMK_E_HUFF_TABLE -2     /* a Huffman table over-subscribes its codes */
#define LLMK_E_HUFF_CODE -3      /* a bit pattern that no code of the table has */
#define LLMK_E_COEF_INDEX -4     /* a run that puts a coefficient past index 63 */
#define LLMK_E_RESTART -5        /* a restart marker missing or out of sequence */
#define LLMK_E_NO_TABLE -6       /* a scan uses a table that was never defined */
#define LLMK_E_PARAMS -7         /* scan or image parameters out of range */
#define LLMK_E_LZW_CODE -8       /* an LZW code past the table */

/* natural (row-major) position of the k-th coefficient in zigzag order */
static const uint8_t NATURAL[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ------------------------------------------------------------------ */
/* bit reader over entropy-coded data (0xFF 0x00 stuffing, markers)    */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *buf;
    int64_t len;
    int64_t pos;       /* next byte to read */
    uint64_t acc;      /* bits, the next one at bit cnt - 1 */
    int cnt;           /* bits in acc */
    int fake;          /* zero bits appended past a marker or the end (the lowest of acc) */
    int marker;        /* a marker (or the end) was reached */
} Bits;

static void bits_fill(Bits *b) {
    while (b->cnt <= 56) {
        uint8_t c = 0;
        if (!b->marker) {
            if (b->pos >= b->len) {
                b->marker = 1;
            } else {
                c = b->buf[b->pos];
                if (c == 0xFF) {
                    if (b->pos + 1 >= b->len) {
                        b->marker = 1;
                    } else if (b->buf[b->pos + 1] == 0x00) {
                        b->pos += 2;
                    } else {
                        b->marker = 1;   /* pos stays on the marker */
                    }
                } else {
                    b->pos += 1;
                }
            }
        }
        if (b->marker) {
            c = 0;
            b->fake += 8;
        }
        b->acc = (b->acc << 8) | c;
        b->cnt += 8;
    }
}

/* n <= 16 bits; -1 when they run into the padding past a marker */
static inline int bits_get(Bits *b, int n) {
    if (n == 0) return 0;
    if (b->cnt < n) bits_fill(b);
    b->cnt -= n;
    if (b->cnt < b->fake) return -1;
    return (int)((b->acc >> b->cnt) & ((1u << n) - 1));
}

static inline int bits_peek(Bits *b, int n) {
    if (b->cnt < n) bits_fill(b);
    return (int)((b->acc >> (b->cnt - n)) & ((1u << n) - 1));
}

/* drop the buffered bits (what is left of a scan or restart interval's
 * last byte, and any bytes read ahead) and move to the next marker: an
 * 0xFF followed by neither 0x00 nor 0xFF. Returns 0, or -1 at the end of
 * the data. */
static int bits_to_marker(Bits *b) {
    int64_t p = b->pos;
    while (p + 1 < b->len && !(b->buf[p] == 0xFF && b->buf[p + 1] != 0x00 &&
                                b->buf[p + 1] != 0xFF))
        p++;
    b->acc = 0;
    b->cnt = 0;
    b->fake = 0;
    b->marker = 0;
    b->pos = p;
    return p + 1 < b->len ? 0 : -1;
}

/* ------------------------------------------------------------------ */
/* Huffman tables                                                      */
/* ------------------------------------------------------------------ */

#define LOOKAHEAD 9

typedef struct {
    int32_t maxcode[18];   /* largest code of each length, -1 if none */
    int32_t valoff[17];    /* symbol index of the first code of each length, less that code */
    uint8_t vals[256];
    uint16_t look[1 << LOOKAHEAD];   /* (length << 8) | symbol, 0 if longer */
} Huff;

/* spec: 16 counts, then the symbols. Validated as libjpeg validates a
 * table: at most 256 symbols, no length's codes reaching its all-ones
 * code, and a DC table's symbols at most 15. */
static int huff_build(Huff *h, const uint8_t *spec, int is_dc) {
    int n = 0;
    for (int l = 0; l < 16; l++) n += spec[l];
    if (n > 256) return LLMK_E_HUFF_TABLE;
    memset(h->vals, 0, sizeof h->vals);
    memcpy(h->vals, spec + 16, (size_t)n);
    if (is_dc)
        for (int i = 0; i < n; i++)
            if (h->vals[i] > 15) return LLMK_E_HUFF_TABLE;
    memset(h->look, 0, sizeof h->look);
    int32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int cnt = spec[l - 1];
        /* the last code of this length must not be all ones (libjpeg's
         * check, made before any of the length's codes is written) */
        if (code + cnt >= (1 << l)) return LLMK_E_HUFF_TABLE;
        if (cnt) {
            h->valoff[l] = p - code;
            for (int i = 0; i < cnt; i++, p++, code++) {
                if (l <= LOOKAHEAD) {
                    int shift = LOOKAHEAD - l;
                    int base = code << shift;
                    for (int j = 0; j < (1 << shift); j++)
                        h->look[base + j] = (uint16_t)((l << 8) | h->vals[p]);
                }
            }
            h->maxcode[l] = code - 1;
        } else {
            h->maxcode[l] = -1;
            h->valoff[l] = 0;
        }
        code <<= 1;
    }
    h->maxcode[17] = 0x7fffffff;
    return LLMK_OK;
}

/* the next symbol, or a negative error code */
static inline int huff_decode(Bits *b, const Huff *h) {
    int peek = bits_peek(b, LOOKAHEAD);
    int e = h->look[peek];
    if (e) {
        int l = e >> 8;
        b->cnt -= l;
        if (b->cnt < b->fake) return LLMK_E_TRUNCATED;
        return e & 0xFF;
    }
    int code = bits_get(b, LOOKAHEAD);
    if (code < 0) return LLMK_E_TRUNCATED;
    int l = LOOKAHEAD;
    while (l <= 16 && code > h->maxcode[l]) {
        int bit = bits_get(b, 1);
        if (bit < 0) return LLMK_E_TRUNCATED;
        code = (code << 1) | bit;
        l++;
    }
    if (l > 16) return LLMK_E_HUFF_CODE;
    return h->vals[h->valoff[l] + code];
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* ------------------------------------------------------------------ */
/* one JPEG scan                                                       */
/* ------------------------------------------------------------------ */

/* comp: per scan component, 8 int32s:
 *   h, v, plane blocks wide, plane blocks high, DC table, AC table,
 *   component blocks wide, component blocks high (the non-interleaved
 *   scan's extent)
 * tables: 8 table specs of 272 bytes (16 counts + 256 symbols), DC 0-3
 *   then AC 0-3; present: which of the 8 are defined
 * planes: one int16 [plane bh, plane bw, 64] array a scan component
 * pos: in, the first byte of the entropy-coded data; out, the marker that
 *   ends the scan
 */
LLMK_API int llmk_jpeg_scan(const uint8_t *buf, int64_t len, int64_t *pos, int32_t ncomp,
                   const int32_t *comp, int16_t **planes, const uint8_t *tables,
                   const int32_t *present, int32_t mcus_x, int32_t mcus_y, int32_t ss,
                   int32_t se, int32_t ah, int32_t al, int32_t progressive,
                   int32_t restart_interval) {
    if (ncomp < 1 || ncomp > 4 || ss < 0 || se > 63 || ss > se || al < 0 || al > 13 ||
        ah < 0 || ah > 13 || mcus_x < 1 || mcus_y < 1 || restart_interval < 0 || *pos < 0 ||
        *pos > len)
        return LLMK_E_PARAMS;
    if (progressive && ncomp > 1 && ss != 0) return LLMK_E_PARAMS;
    int blocks_in_mcu = 0;
    for (int c = 0; c < ncomp; c++) {
        const int32_t *ci = comp + 8 * c;
        if (ci[0] < 1 || ci[0] > 4 || ci[1] < 1 || ci[1] > 4 || ci[2] < 1 || ci[3] < 1 ||
            ci[4] < 0 || ci[4] > 3 || ci[5] < 0 || ci[5] > 3 || ci[6] < 1 || ci[7] < 1 ||
            ci[6] > ci[2] || ci[7] > ci[3])
            return LLMK_E_PARAMS;
        if (ncomp > 1 && ((int64_t)mcus_x * ci[0] > ci[2] || (int64_t)mcus_y * ci[1] > ci[3]))
            return LLMK_E_PARAMS;
        blocks_in_mcu += ci[0] * ci[1];
    }
    if (ncomp > 1 && blocks_in_mcu > 10) return LLMK_E_PARAMS;
    /* the tables this scan decodes with (on the stack, where the
     * sanitizers see every access) */
    Huff dc[4], ac[4];
    int need_dc = ss == 0 && ah == 0;
    int need_ac = ss > 0;
    for (int c = 0; c < ncomp; c++) {
        const int32_t *ci = comp + 8 * c;
        if (need_dc) {
            if (!present[ci[4]]) return LLMK_E_NO_TABLE;
            int err = huff_build(&dc[ci[4]], tables + 272 * ci[4], 1);
            if (err) return err;
        }
        if (need_ac || !progressive) {
            if (!present[4 + ci[5]]) return LLMK_E_NO_TABLE;
            int err = huff_build(&ac[ci[5]], tables + 272 * (4 + ci[5]), 0);
            if (err) return err;
        }
    }
    Bits b = {buf, len, *pos, 0, 0, 0, 0};
    int32_t pred[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    int64_t total, per_row;
    if (ncomp == 1) {
        per_row = comp[6];
        total = (int64_t)comp[6] * comp[7];
    } else {
        per_row = mcus_x;
        total = (int64_t)mcus_x * mcus_y;
    }
    int next_rst = 0;
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    for (int64_t m = 0; m < total; m++) {
        if (restart_interval && m > 0 && m % restart_interval == 0) {
            if (bits_to_marker(&b)) return LLMK_E_TRUNCATED;
            if (b.buf[b.pos + 1] != 0xD0 + next_rst) return LLMK_E_RESTART;
            b.pos += 2;
            next_rst = (next_rst + 1) & 7;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            eobrun = 0;
        }
        int64_t my = m / per_row, mx = m % per_row;
        for (int c = 0; c < ncomp; c++) {
            const int32_t *ci = comp + 8 * c;
            int H = ncomp == 1 ? 1 : ci[0], V = ncomp == 1 ? 1 : ci[1];
            for (int v = 0; v < V; v++) {
                for (int h = 0; h < H; h++) {
                    int64_t by = my * V + v, bx = mx * H + h;
                    int16_t *blk = planes[c] + (by * ci[2] + bx) * 64;
                    if (!progressive) {
                        int s = huff_decode(&b, &dc[ci[4]]);
                        if (s < 0) return s;
                        int d = 0;
                        if (s) {
                            int r = bits_get(&b, s);
                            if (r < 0) return LLMK_E_TRUNCATED;
                            d = extend(r, s);
                        }
                        pred[c] = (int32_t)((uint32_t)pred[c] + (uint32_t)d);  /* wraps, no UB */
                        blk[0] = (int16_t)pred[c];
                        for (int k = 1; k < 64; k++) {
                            int rs = huff_decode(&b, &ac[ci[5]]);
                            if (rs < 0) return rs;
                            int r = rs >> 4, sz = rs & 15;
                            if (sz) {
                                k += r;
                                if (k > 63) return LLMK_E_COEF_INDEX;
                                int bitsv = bits_get(&b, sz);
                                if (bitsv < 0) return LLMK_E_TRUNCATED;
                                blk[NATURAL[k]] = (int16_t)extend(bitsv, sz);
                            } else {
                                if (r != 15) break;
                                k += 15;
                            }
                        }
                    } else if (ss == 0 && ah == 0) {          /* DC first */
                        int s = huff_decode(&b, &dc[ci[4]]);
                        if (s < 0) return s;
                        int d = 0;
                        if (s) {
                            int r = bits_get(&b, s);
                            if (r < 0) return LLMK_E_TRUNCATED;
                            d = extend(r, s);
                        }
                        pred[c] = (int32_t)((uint32_t)pred[c] + (uint32_t)d);  /* wraps, no UB */
                        blk[0] = (int16_t)((unsigned)pred[c] << al);
                    } else if (ss == 0) {                     /* DC refine */
                        int bit = bits_get(&b, 1);
                        if (bit < 0) return LLMK_E_TRUNCATED;
                        if (bit) blk[0] = (int16_t)(blk[0] | p1);
                    } else if (ah == 0) {                     /* AC first */
                        if (eobrun > 0) {
                            eobrun--;
                            continue;
                        }
                        for (int k = ss; k <= se; k++) {
                            int rs = huff_decode(&b, &ac[ci[5]]);
                            if (rs < 0) return rs;
                            int r = rs >> 4, sz = rs & 15;
                            if (sz) {
                                k += r;
                                if (k > 63) return LLMK_E_COEF_INDEX;
                                int bitsv = bits_get(&b, sz);
                                if (bitsv < 0) return LLMK_E_TRUNCATED;
                                blk[NATURAL[k]] = (int16_t)((unsigned)extend(bitsv, sz) << al);
                            } else if (r == 15) {
                                k += 15;
                            } else {
                                eobrun = (int64_t)1 << r;
                                if (r) {
                                    int x = bits_get(&b, r);
                                    if (x < 0) return LLMK_E_TRUNCATED;
                                    eobrun += x;
                                }
                                eobrun--;
                                break;
                            }
                        }
                    } else {                                  /* AC refine */
                        int k = ss;
                        if (eobrun == 0) {
                            for (; k <= se; k++) {
                                int rs = huff_decode(&b, &ac[ci[5]]);
                                if (rs < 0) return rs;
                                int r = rs >> 4, sz = rs & 15, val = 0;
                                if (sz) {
                                    int bit = bits_get(&b, 1);
                                    if (bit < 0) return LLMK_E_TRUNCATED;
                                    val = bit ? p1 : m1;
                                } else if (r != 15) {
                                    eobrun = (int64_t)1 << r;
                                    if (r) {
                                        int x = bits_get(&b, r);
                                        if (x < 0) return LLMK_E_TRUNCATED;
                                        eobrun += x;
                                    }
                                    break;
                                }
                                do {
                                    int16_t *co = blk + NATURAL[k];
                                    if (*co != 0) {
                                        int bit = bits_get(&b, 1);
                                        if (bit < 0) return LLMK_E_TRUNCATED;
                                        if (bit && (*co & p1) == 0)
                                            *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
                                    } else if (--r < 0) {
                                        break;
                                    }
                                    k++;
                                } while (k <= se);
                                if (val) {
                                    if (k > 63) return LLMK_E_COEF_INDEX;
                                    blk[NATURAL[k]] = (int16_t)val;
                                }
                            }
                        }
                        if (eobrun > 0) {
                            for (; k <= se; k++) {
                                int16_t *co = blk + NATURAL[k];
                                if (*co != 0) {
                                    int bit = bits_get(&b, 1);
                                    if (bit < 0) return LLMK_E_TRUNCATED;
                                    if (bit && (*co & p1) == 0)
                                        *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
                                }
                            }
                            eobrun--;
                        }
                    }
                }
            }
        }
    }
    /* the scan's data ends at a marker: skip the padding to it */
    if (bits_to_marker(&b)) return LLMK_E_TRUNCATED;
    *pos = b.pos;
    return LLMK_OK;
}

/* ------------------------------------------------------------------ */
/* GIF LZW                                                             */
/* ------------------------------------------------------------------ */

/* Decode one image descriptor's data: the sub-blocks from *pos (length
 * byte, bytes, ..., a zero length) into npix palette indices. *pos moves
 * past the block terminator; *written is the indices decoded (at most
 * npix: codes past the frame are read and dropped). */
LLMK_API int llmk_gif_lzw(const uint8_t *buf, int64_t len, int64_t *pos, int32_t min_code_size,
                 uint8_t *out, int64_t npix, int64_t *written) {
    if (min_code_size < 1 || min_code_size > 11 || *pos < 0 || *pos > len || npix < 0)
        return LLMK_E_PARAMS;
    uint16_t prefix[4096];
    uint8_t suffix[4096];
    uint8_t first[4096];
    uint8_t stack[4097];
    const int clear = 1 << min_code_size, end = clear + 1;
    int size = min_code_size + 1, next = clear + 2, prev = -1;
    for (int i = 0; i < clear; i++) {
        prefix[i] = 0xFFFF;
        suffix[i] = (uint8_t)i;
        first[i] = (uint8_t)i;
    }
    int64_t p = *pos, n = 0;
    int64_t block_left = 0;
    uint32_t acc = 0;
    int cnt = 0, done = 0;
    while (!done) {
        /* gather bits for one code */
        while (cnt < size) {
            if (block_left == 0) {
                if (p >= len) return LLMK_E_TRUNCATED;
                block_left = buf[p++];
                if (block_left == 0) {   /* terminator inside the stream */
                    done = 2;
                    break;
                }
            }
            if (p >= len) return LLMK_E_TRUNCATED;
            acc |= (uint32_t)buf[p++] << cnt;
            cnt += 8;
            block_left--;
        }
        if (done) break;
        int code = (int)(acc & ((1u << size) - 1));
        acc >>= size;
        cnt -= size;
        if (code == clear) {
            size = min_code_size + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == end) {
            done = 1;
            break;
        }
        int c = code, sp = 0;
        if (prev < 0) {
            if (code >= clear) return LLMK_E_LZW_CODE;
        } else if (code > next || (code == next && next >= 4096)) {
            return LLMK_E_LZW_CODE;
        }
        if (prev >= 0 && code == next) {
            stack[sp++] = first[prev];
            c = prev;
        }
        while (c >= clear) {
            if (sp >= 4096) return LLMK_E_LZW_CODE;
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = (uint8_t)c;
        uint8_t head = (uint8_t)c;
        while (sp > 0) {
            sp--;
            if (n < npix) out[n] = stack[sp];
            n++;
        }
        if (prev >= 0 && next < 4096) {
            prefix[next] = (uint16_t)prev;
            suffix[next] = head;
            first[next] = first[prev];
            next++;
            if (next == (1 << size) && size < 12) size++;
        }
        prev = code;
    }
    /* the rest of the sub-blocks up to the terminator */
    if (done == 1) {
        p += block_left;
        for (;;) {
            if (p >= len) return LLMK_E_TRUNCATED;
            int k = buf[p++];
            if (k == 0) break;
            p += k;
        }
    }
    if (p > len) return LLMK_E_TRUNCATED;
    *pos = p;
    *written = n < npix ? n : npix;
    return LLMK_OK;
}
