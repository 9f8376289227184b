/* seqoia_tpu native runtime: clean-room C implementation of the SQOA/QOI
 * codec wire format.
 *
 * This is an original implementation written from the format specification
 * (reference documentation: seqoia.h:65-282) and the behavioral contract
 * captured in SURVEY.md §2.1/§2.2. It serves three roles in the framework:
 *
 *   1. host-side fast path (en/decode without a TPU in the loop),
 *   2. parity oracle for the TPU (JAX/Pallas) codec tests,
 *   3. sequential fallback for decode features the parallel TPU path
 *      routes around (SQOA_OP_REF back-references, reference: seqoia.h:729-738).
 *
 * Exposed via ctypes (see bindings.py). All functions are thread-safe and
 * allocation-free: callers provide output buffers.
 *
 * Build: cc -O3 -shared -fPIC -o libsqoa_native.so sqoa_native.c
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ---- wire format constants (reference: seqoia.h:398-439) ---------------- */

enum {
    TAG_REF_LIMIT = 0x60,  /* bytes < 0x60 are OP_REF in SQOA mode         */
    TAG_ALPHA     = 0x60,  /* 011xxxxx                                      */
    TAG_LUMA      = 0x80,  /* 10xxxxxx                                      */
    TAG_RUN       = 0xc0,  /* 11xxxxxx                                      */
    TAG_BIGRUN    = 0xfd,
    TAG_RGB       = 0xfe,
    TAG_RGBA      = 0xff,
    TAG_QOI_DIFF  = 0x40,  /* 01xxxxxx, QOI compat only                     */
};

#define MASK2          0xc0
#define SQOA_MAXRUN_   512
#define QOI_MAXRUN_    62
#define HDR_SIZE       14
#define PAD_SIZE       8
#define START_BYTE_    0x31
#define PIXELS_MAX_    400000000u

#define MAGIC_SQOA     0x53716f61u /* "Sqoa" */
#define MAGIC_QOIF     0x716f6966u /* "qoif" */

typedef struct { uint8_t r, g, b, a; } px_t;

static inline uint32_t px_pack(px_t p) {
    return (uint32_t)p.r | ((uint32_t)p.g << 8) | ((uint32_t)p.b << 16) |
           ((uint32_t)p.a << 24);
}

static inline int hash6(px_t p) {
    /* reference: seqoia.h:414-417 */
    return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11);
}

static inline void put_be32(uint8_t *dst, uint32_t v) {
    dst[0] = (uint8_t)(v >> 24);
    dst[1] = (uint8_t)(v >> 16);
    dst[2] = (uint8_t)(v >> 8);
    dst[3] = (uint8_t)v;
}

static inline uint32_t get_be32(const uint8_t *src) {
    return ((uint32_t)src[0] << 24) | ((uint32_t)src[1] << 16) |
           ((uint32_t)src[2] << 8) | (uint32_t)src[3];
}

/* ---- encoder ------------------------------------------------------------ */

/* Emit the byte sequence that flushes a pending run of `run` pixels
 * (1 <= run < max_run). Chunking: repeated RUN|60 for each full 61, then a
 * final RUN|(rem-1). (reference behavior: seqoia.h:554-561) */
static inline int emit_run_flush(uint8_t *out, int run) {
    int n = 0;
    while (run > 61) {
        out[n++] = (uint8_t)(TAG_RUN | 60);
        run -= 61;
    }
    out[n++] = (uint8_t)(TAG_RUN | (run - 1));
    return n;
}

/* Specialized QOI-compat color encode (colch==3, stride 3 or 4).
 *
 * The generic loop below carries SQOA-mode state (512-px BIGRUN chunking,
 * LUMA+ALPHA pairing, mono handling) that compat color streams never use.
 * This path exploits three compat-mode invariants to run branch-lean:
 *
 *   - runs cap at 62 (QOI_MAXRUN), so a pending run always flushes as ONE
 *     byte (the generic 61-chunking while-loop can't fire);
 *   - an op-emitting pixel with a changed alpha always lands in INDEX or
 *     RGBA (hash hit => table entry equals the pixel *including* alpha;
 *     miss + alpha change => RGBA, seqoia.h:563-582), so the DIFF/LUMA/RGB
 *     fall-through runs with da==0 and needs no alpha checks at all;
 *   - the pixel packs into one u32, making prev-compare and table-compare
 *     single compares instead of 4-byte struct compares.
 *
 * Emission order matches the reference exactly (hash -> DIFF -> LUMA ->
 * RGB, seqoia.h:563-634); trailing run is a single 0xfd regardless of
 * length (seqoia.h:640-642). Returns bytes written after the header.
 */
static int64_t encode_qoi3_fast(const uint8_t *pixels, int64_t npx,
                                int stride, uint8_t *out) {
    uint32_t table[64];
    memset(table, 0, sizeof table);
    uint8_t pr = 0, pg = 0, pb = 0, pa = 255;
    uint32_t prevw = 0xff000000u;
    int64_t n = 0;
    int run = 0;
    const uint8_t *p = pixels;
    const uint8_t *pend = pixels + npx * stride;

/* The per-pixel body, shared between the stride-3 and stride-4 loops below
 * via a macro so each loop compiles with its stride a constant (no per-pixel
 * stride branch, and the stride-3 loop drops alpha handling entirely:
 * a==pa==255 always, so the RGBA arm is dead there). */
#define QOI3_BODY(R, G, B, A, HAS_ALPHA)                                     \
    do {                                                                     \
        uint8_t r = (R), g = (G), b = (B), a = (A);                          \
        uint32_t curw = (uint32_t)r | ((uint32_t)g << 8) |                   \
                        ((uint32_t)b << 16) | ((uint32_t)a << 24);           \
        if (curw == prevw) {                                                 \
            if (++run == QOI_MAXRUN_) { out[n++] = TAG_BIGRUN; run = 0; }    \
            break;                                                           \
        }                                                                    \
        if (run) { out[n++] = (uint8_t)(TAG_RUN | (run - 1)); run = 0; }     \
        unsigned slot = (r * 3u + g * 5u + b * 7u + a * 11u) & 63u;          \
        if (table[slot] == curw) {                                           \
            out[n++] = (uint8_t)slot;                                        \
        } else {                                                             \
            table[slot] = curw;                                              \
            if (HAS_ALPHA && a != pa) {                                      \
                out[n] = TAG_RGBA;                                           \
                out[n + 1] = r; out[n + 2] = g; out[n + 3] = b;              \
                out[n + 4] = a;                                              \
                n += 5;                                                      \
            } else {                                                         \
                uint8_t dr = (uint8_t)(r - pr), dg = (uint8_t)(g - pg),      \
                        db = (uint8_t)(b - pb);                              \
                if ((uint8_t)(dr + 2) < 4 && (uint8_t)(dg + 2) < 4 &&        \
                    (uint8_t)(db + 2) < 4) {                                 \
                    out[n++] = (uint8_t)(TAG_QOI_DIFF |                      \
                                         ((uint8_t)(dr + 2) << 4) |          \
                                         ((uint8_t)(dg + 2) << 2) |          \
                                         (uint8_t)(db + 2));                 \
                } else if ((uint8_t)(dg + 32) < 64 &&                        \
                           (uint8_t)(dr - dg + 8) < 16 &&                    \
                           (uint8_t)(db - dg + 8) < 16) {                    \
                    out[n] = (uint8_t)(TAG_LUMA | (uint8_t)(dg + 32));       \
                    out[n + 1] = (uint8_t)(((uint8_t)(dr - dg + 8) << 4) |   \
                                           (uint8_t)(db - dg + 8));          \
                    n += 2;                                                  \
                } else {                                                     \
                    out[n] = TAG_RGB;                                        \
                    out[n + 1] = r; out[n + 2] = g; out[n + 3] = b;          \
                    n += 4;                                                  \
                }                                                            \
            }                                                                \
        }                                                                    \
        prevw = curw;                                                        \
        pr = r; pg = g; pb = b; pa = a;                                      \
    } while (0)

    if (stride == 4) {
        while (p < pend) {
            QOI3_BODY(p[0], p[1], p[2], p[3], 1);
            p += 4;
        }
    } else {
        while (p < pend) {
            QOI3_BODY(p[0], p[1], p[2], 255, 0);
            p += 3;
        }
    }
#undef QOI3_BODY
    if (run) out[n++] = TAG_BIGRUN; /* trailing run (seqoia.h:640-642) */
    return n;
}

/* Encode one image. Returns the number of bytes written, or -1 on invalid
 * arguments. `out` must hold at least w*h*(norm_channels+1)+22 bytes.
 *
 * channels: 1..6 per the SQOA channel enum; BGR/BGRA are *not* swizzled
 * (matches reference behavior, seqoia.h:531-541 reads r,g,b positionally).
 */
int64_t sqn_encode(const uint8_t *pixels, uint32_t width, uint32_t height,
                   int channels, int colorspace, int qoi_compat,
                   uint8_t *out) {
    if (!pixels || !out) return -1;
    if (width == 0 || height == 0) return -1;
    if (channels < 1 || channels > 6) return -1;
    if (colorspace < 0 || colorspace > 1) return -1;
    if (height >= PIXELS_MAX_ / width) return -1;

    int has_alpha = (channels & 1) == 0;
    int colch;
    if (channels < 3) {
        if (qoi_compat) return -1; /* mono + QOI rejected (seqoia.h:477-480) */
        colch = 1;
    } else {
        colch = 3;
    }
    int stride = colch + has_alpha;
    int max_run = qoi_compat ? QOI_MAXRUN_ : SQOA_MAXRUN_;

    int64_t n = 0;
    put_be32(out + n, qoi_compat ? MAGIC_QOIF : MAGIC_SQOA); n += 4;
    put_be32(out + n, width); n += 4;
    put_be32(out + n, height); n += 4;
    out[n++] = (uint8_t)stride;
    out[n++] = (uint8_t)colorspace;
    if (!qoi_compat) out[n++] = START_BYTE_;

    if (qoi_compat && colch == 3) {
        n += encode_qoi3_fast(pixels, (int64_t)width * height, stride,
                              out + n);
        memset(out + n, 0, 7); n += 7;
        out[n++] = 1;
        return n;
    }

    px_t table[64];
    memset(table, 0, sizeof table);

    px_t cur = {0, 0, 0, 255};
    px_t prev = cur;
    int run = 0;

    int64_t total = (int64_t)width * height * stride;
    for (int64_t pos = 0; pos < total; pos += stride) {
        if (colch == 3) {
            cur.r = pixels[pos];
            cur.g = pixels[pos + 1];
            cur.b = pixels[pos + 2];
        } else {
            cur.g = pixels[pos];
        }
        if (has_alpha) cur.a = pixels[pos + colch];

        if (px_pack(cur) == px_pack(prev)) {
            if (++run == max_run) {
                out[n++] = TAG_BIGRUN; /* in QOI mode this is RUN|61 == 62px */
                run = 0;
            }
            continue;
        }

        if (run > 0) {
            n += emit_run_flush(out + n, run);
            run = 0;
        }

        int handled = 0;
        if (qoi_compat) {
            int slot = hash6(cur) % 64;
            if (px_pack(table[slot]) == px_pack(cur)) {
                out[n++] = (uint8_t)slot; /* QOI_OP_INDEX */
                handled = 1;
            } else {
                table[slot] = cur; /* insert on every miss (seqoia.h:571) */
                if (cur.a != prev.a) {
                    out[n++] = TAG_RGBA;
                    out[n++] = cur.r;
                    out[n++] = cur.g;
                    out[n++] = cur.b;
                    out[n++] = cur.a;
                    handled = 1;
                }
            }
        }

        if (!handled) {
            /* deltas use int8 wraparound semantics */
            int8_t dr = (int8_t)(cur.r - prev.r);
            int8_t dg = (int8_t)(cur.g - prev.g);
            int8_t db = (int8_t)(cur.b - prev.b);
            int8_t da = (int8_t)(cur.a - prev.a);
            int8_t dr_dg = (int8_t)(dr - dg);
            int8_t db_dg = (int8_t)(db - dg);
            int alpha_changed = (da != 0);

            if (qoi_compat &&
                dr >= -2 && dr <= 1 && dg >= -2 && dg <= 1 &&
                db >= -2 && db <= 1) {
                out[n++] = (uint8_t)(TAG_QOI_DIFF | ((dr + 2) << 4) |
                                     ((dg + 2) << 2) | (db + 2));
            } else if (colch == 1 && alpha_changed) {
                out[n++] = TAG_RGBA; /* mono gray+alpha pair (seqoia.h:601-605) */
                out[n++] = cur.g;
                out[n++] = cur.a;
            } else if (dr_dg >= -8 && dr_dg <= 7 && dg >= -32 && dg <= 31 &&
                       db_dg >= -8 && db_dg <= 7 && da >= -16 && da <= 15) {
                out[n++] = (uint8_t)(TAG_LUMA | (dg + 32));
                if (colch == 3) {
                    out[n++] = (uint8_t)(((dr_dg + 8) << 4) | (db_dg + 8));
                    if (alpha_changed)
                        out[n++] = (uint8_t)(TAG_ALPHA | (da + 16));
                }
            } else {
                out[n++] = (uint8_t)(TAG_RGB | alpha_changed);
                if (colch == 3) {
                    out[n++] = cur.r;
                    out[n++] = cur.g;
                    out[n++] = cur.b;
                } else {
                    out[n++] = cur.g;
                }
                if (alpha_changed) out[n++] = cur.a;
            }
        }
        prev = cur;
    }

    if (run > 0)
        out[n++] = TAG_BIGRUN; /* trailing run, any length (seqoia.h:640-642) */

    memset(out + n, 0, 7); n += 7;
    out[n++] = 1;
    return n;
}

/* ---- decoder ------------------------------------------------------------ */

/* Byte cursor with SQOA_OP_REF replay support. `replay_end` < 0 means no
 * replay window is active. When the cursor reaches `replay_end` it jumps to
 * `resume + 1` and reads there (exactly mirrors the reference SQOA_NEXT
 * macro's semantics, reference: seqoia.h:418). */
typedef struct {
    const uint8_t *bytes;
    int64_t pos;
    int64_t replay_end; /* "ref" in the reference */
    int64_t resume;     /* "refp" in the reference */
} cursor_t;

static inline uint8_t cur_next(cursor_t *c) {
    if (c->pos == c->replay_end) {
        c->pos = c->resume + 1;
        return c->bytes[c->pos];
    }
    return c->bytes[c->pos++];
}

/* Specialized QOI-compat color decode (colch==3, output 3 or 4 channels).
 *
 * The generic loop below pays per-pixel for generality it doesn't need in
 * this (hottest) configuration: a replay-aware cursor (REF cannot occur in
 * compat streams), per-pixel output-format branches, and a run counter
 * drained one pixel per outer iteration. This path walks the stream with a
 * raw pointer, keeps the pixel packed in a register, fills runs in a tight
 * clamped loop (vectorizable), and updates the hash table once per op
 * (reference semantics update it once per *pixel*, seqoia.h:785-787, but
 * every pixel of a run re-inserts an identical value into the same slot,
 * so per-op insertion is equivalent — note the insert must still happen
 * for RUN and INDEX ops themselves: on decoder-only streams an INDEX read
 * of a never-written slot yields (0,0,0,0), whose re-insert at slot 0 can
 * clobber a live entry, exactly as the reference does). Dispatch ranges
 * mirror the reference order (8-bit tags first, seqoia.h:99-100):
 * [0xc0,0xff] RUN/RGB/RGBA, [0,0x40) INDEX, [0x40,0x80) DIFF,
 * [0x80,0xc0) LUMA.
 */
static int64_t decode_qoi3_fast(const uint8_t *data, int64_t size,
                                uint8_t *out, int out_ch, int64_t npx) {
    const uint8_t *q = data + HDR_SIZE;
    const uint8_t *qend = data + size - PAD_SIZE;
    uint32_t table[64];
    memset(table, 0, sizeof table);
    uint8_t r = 0, g = 0, b = 0, a = 255;
    uint32_t pxw = 0xff000000u;

    if (out_ch == 4) {
        uint32_t *op = (uint32_t *)(void *)out;
        uint32_t *op_end = op + npx;
        while (op < op_end) {
            if (q >= qend) { *op++ = pxw; continue; }
            uint32_t b1 = *q++;
            if (b1 >= TAG_RUN) {
                if (b1 < TAG_RGB) { /* run 1..62 (0xfd == RUN|61 == 62 px) */
                    table[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = pxw;
                    int64_t run = (int64_t)(b1 & 0x3f) + 1;
                    if (run > op_end - op) run = op_end - op;
                    for (int64_t i = 0; i < run; i++) op[i] = pxw;
                    op += run;
                    continue;
                }
                r = q[0]; g = q[1]; b = q[2];
                if (b1 == TAG_RGBA) { a = q[3]; q += 4; } else { q += 3; }
            } else if (b1 < 64) { /* INDEX */
                pxw = table[b1];
                r = (uint8_t)pxw; g = (uint8_t)(pxw >> 8);
                b = (uint8_t)(pxw >> 16); a = (uint8_t)(pxw >> 24);
                table[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = pxw;
                *op++ = pxw;
                continue;
            } else if (b1 < TAG_LUMA) { /* DIFF */
                r = (uint8_t)(r + ((b1 >> 4) & 3) - 2);
                g = (uint8_t)(g + ((b1 >> 2) & 3) - 2);
                b = (uint8_t)(b + (b1 & 3) - 2);
            } else { /* LUMA */
                int dg = (int)(b1 & 0x3f) - 32;
                uint32_t b2 = *q++;
                r = (uint8_t)(r + dg - 8 + ((b2 >> 4) & 15));
                g = (uint8_t)(g + dg);
                b = (uint8_t)(b + dg - 8 + (b2 & 15));
            }
            pxw = (uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16)
                | ((uint32_t)a << 24);
            table[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = pxw;
            *op++ = pxw;
        }
        return npx * 4;
    }

    uint8_t *op = out;
    uint8_t *op_end = out + npx * 3;
    while (op < op_end) {
        if (q >= qend) {
            op[0] = r; op[1] = g; op[2] = b; op += 3;
            continue;
        }
        uint32_t b1 = *q++;
        if (b1 >= TAG_RUN) {
            if (b1 < TAG_RGB) {
                table[(r * 3 + g * 5 + b * 7 + a * 11) & 63] =
                    (uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16)
                    | ((uint32_t)a << 24);
                int64_t run = (int64_t)(b1 & 0x3f) + 1;
                if (run > (op_end - op) / 3) run = (op_end - op) / 3;
                for (int64_t i = 0; i < run; i++) {
                    op[0] = r; op[1] = g; op[2] = b; op += 3;
                }
                continue;
            }
            r = q[0]; g = q[1]; b = q[2];
            if (b1 == TAG_RGBA) { a = q[3]; q += 4; } else { q += 3; }
        } else if (b1 < 64) {
            uint32_t v = table[b1];
            r = (uint8_t)v; g = (uint8_t)(v >> 8);
            b = (uint8_t)(v >> 16); a = (uint8_t)(v >> 24);
            table[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = v;
            op[0] = r; op[1] = g; op[2] = b; op += 3;
            continue;
        } else if (b1 < TAG_LUMA) {
            r = (uint8_t)(r + ((b1 >> 4) & 3) - 2);
            g = (uint8_t)(g + ((b1 >> 2) & 3) - 2);
            b = (uint8_t)(b + (b1 & 3) - 2);
        } else {
            int dg = (int)(b1 & 0x3f) - 32;
            uint32_t b2 = *q++;
            r = (uint8_t)(r + dg - 8 + ((b2 >> 4) & 15));
            g = (uint8_t)(g + dg);
            b = (uint8_t)(b + dg - 8 + (b2 & 15));
        }
        table[(r * 3 + g * 5 + b * 7 + a * 11) & 63] =
            (uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16)
            | ((uint32_t)a << 24);
        op[0] = r; op[1] = g; op[2] = b; op += 3;
    }
    return npx * 3;
}

/* Decode one image.
 *
 * data/size: the full file bytes. force_channels: 0 = use header channels,
 * otherwise force output channel count (must be <= 4). desc_out receives
 * {width, height, channels, colorspace, qoi_compat}.
 *
 * out_pixels must hold width*height*out_channels bytes, where out_channels is
 * force_channels if nonzero, else the normalized header channel count. Call
 * sqn_peek_header first to size the buffer.
 *
 * Returns bytes written to out_pixels, or -1 on malformed input.
 */
int64_t sqn_decode(const uint8_t *data, int64_t size, int force_channels,
                   uint8_t *out_pixels, uint32_t desc_out[5]) {
    if (!data || !out_pixels || size < HDR_SIZE + PAD_SIZE) return -1;
    if (force_channels > 4 || force_channels < 0) return -1;

    uint32_t magic = get_be32(data);
    uint32_t width = get_be32(data + 4);
    uint32_t height = get_be32(data + 8);
    int hdr_channels = data[12];
    int colorspace = data[13];
    int qoi_compat = (data[14] != START_BYTE_);

    if (width == 0 || height == 0) return -1;
    if (hdr_channels < 1 || hdr_channels > 6) return -1;
    if (colorspace > 1) return -1;
    if (magic != MAGIC_SQOA && magic != MAGIC_QOIF) return -1;
    if (magic == MAGIC_QOIF && !qoi_compat) return -1;
    if (height >= PIXELS_MAX_ / width) return -1;

    int colch, index_size;
    if (hdr_channels < 3) {
        colch = 1;
        index_size = 128; /* mono widens the index (seqoia.h:690-693) */
    } else {
        colch = 3;
        index_size = 64;
    }

    int channels = force_channels;
    int add_alpha = (channels & 1) == 0;
    if (channels == 0) {
        add_alpha = (hdr_channels & 1) == 0;
        channels = colch + add_alpha;
    }

    int64_t p = HDR_SIZE;
    if (!qoi_compat) {
        if (data[p] != START_BYTE_) return -1;
        p++;
    }

    if (desc_out) {
        desc_out[0] = width;
        desc_out[1] = height;
        desc_out[2] = (uint32_t)hdr_channels;
        desc_out[3] = (uint32_t)colorspace;
        desc_out[4] = (uint32_t)qoi_compat;
    }

    if (qoi_compat && colch == 3 && channels >= 3 &&
        (channels == 3 || ((uintptr_t)out_pixels & 3) == 0))
        return decode_qoi3_fast(data, size, out_pixels, channels,
                                (int64_t)width * height);

    px_t table[128];
    memset(table, 0, sizeof table);
    px_t px = {0, 0, 0, 255};

    cursor_t c = {data, p, -1, 0};
    int64_t chunks_len = size - PAD_SIZE;
    int64_t px_len = (int64_t)width * height * channels;
    int run = 0;

    for (int64_t pos = 0; pos < px_len; pos += channels) {
        if (run > 0) {
            run--;
        } else if (c.pos < chunks_len) {
            int b1 = cur_next(&c);

            if (!qoi_compat && b1 < TAG_REF_LIMIT) {
                /* OP_REF: replay `2+(b1>>5)` bytes ending (b1&31) back from
                 * the current position (reference: seqoia.h:729-738). */
                c.resume = c.pos;
                c.replay_end = c.pos - (b1 & 31);
                c.pos = c.replay_end - 2 - (b1 >> 5);
                if (c.pos < 0) return -1;
                b1 = c.bytes[c.pos++];
            }

            if (b1 == TAG_RGB || b1 == TAG_RGBA) {
                if (colch == 3) {
                    px.r = cur_next(&c);
                    px.g = cur_next(&c);
                    px.b = cur_next(&c);
                } else {
                    px.g = cur_next(&c);
                }
                if (b1 == TAG_RGBA) px.a = cur_next(&c);
            } else if (qoi_compat && b1 < index_size) {
                px = table[b1];
            } else if (qoi_compat && (b1 & MASK2) == TAG_QOI_DIFF) {
                px.r = (uint8_t)(px.r + ((b1 >> 4) & 3) - 2);
                px.g = (uint8_t)(px.g + ((b1 >> 2) & 3) - 2);
                px.b = (uint8_t)(px.b + (b1 & 3) - 2);
            } else if ((b1 & MASK2) == TAG_LUMA) {
                int dg = (b1 & 0x3f) - 32;
                px.g = (uint8_t)(px.g + dg);
                if (colch == 3) {
                    int b2 = cur_next(&c);
                    px.r = (uint8_t)(px.r + dg - 8 + ((b2 >> 4) & 0x0f));
                    px.b = (uint8_t)(px.b + dg - 8 + (b2 & 0x0f));
                }
            } else if (!qoi_compat && b1 == TAG_BIGRUN) {
                run = SQOA_MAXRUN_ - 1;
            } else {
                run = b1 & 0x3f;
            }

            /* alpha-delta peek: a trailing 011xxxxx byte updates the pixel
             * just decoded (SQOA color mode only, reference: seqoia.h:777-783).
             * NB the peek inspects bytes[pos] directly but consumes through
             * the replay-aware cursor. */
            if (!qoi_compat && colch == 3 &&
                c.bytes[c.pos] >= TAG_ALPHA && c.bytes[c.pos] < TAG_LUMA) {
                b1 = cur_next(&c);
                px.a = (uint8_t)(px.a + (b1 & 0x1f) - 16);
            }

            if (qoi_compat)
                table[hash6(px) % index_size] = px;
        }

        if (channels >= 3 && colch == 3) {
            out_pixels[pos] = px.r;
            out_pixels[pos + 1] = px.g;
            out_pixels[pos + 2] = px.b;
        } else {
            out_pixels[pos] = px.g;
            if (channels >= 3) {
                out_pixels[pos + 1] = px.g;
                out_pixels[pos + 2] = px.g;
            }
        }
        if (add_alpha) out_pixels[pos + channels - 1] = px.a;
    }

    return px_len;
}

/* Parse just the header. Returns 0 on success, -1 on malformed header.
 * desc_out receives {width, height, channels, colorspace, qoi_compat}. */
int sqn_peek_header(const uint8_t *data, int64_t size, uint32_t desc_out[5]) {
    if (!data || size < HDR_SIZE + PAD_SIZE) return -1;
    uint32_t magic = get_be32(data);
    uint32_t width = get_be32(data + 4);
    uint32_t height = get_be32(data + 8);
    int channels = data[12];
    int colorspace = data[13];
    int qoi_compat = (data[14] != START_BYTE_);
    if (width == 0 || height == 0) return -1;
    if (channels < 1 || channels > 6) return -1;
    if (colorspace > 1) return -1;
    if (magic != MAGIC_SQOA && magic != MAGIC_QOIF) return -1;
    if (magic == MAGIC_QOIF && !qoi_compat) return -1;
    if (height >= PIXELS_MAX_ / width) return -1;
    desc_out[0] = width;
    desc_out[1] = height;
    desc_out[2] = (uint32_t)channels;
    desc_out[3] = (uint32_t)colorspace;
    desc_out[4] = (uint32_t)qoi_compat;
    return 0;
}

/* ---- batch APIs ---------------------------------------------------------
 * Simple loops for now; per-image independence means these are trivially
 * parallel (the TPU path is the throughput path; this is the host fallback).
 */

/* Encode `count` images with identical geometry packed contiguously in
 * `pixels`. Outputs are written back-to-back into `out` at stride
 * `out_stride`; per-image lengths land in `lengths`. Returns number of
 * successfully encoded images. */
int64_t sqn_encode_batch(const uint8_t *pixels, uint32_t width,
                         uint32_t height, int channels, int colorspace,
                         int qoi_compat, int64_t count, uint8_t *out,
                         int64_t out_stride, int64_t *lengths) {
    int has_alpha = (channels & 1) == 0;
    int colch = channels < 3 ? 1 : 3;
    int64_t in_stride = (int64_t)width * height * (colch + has_alpha);
    int64_t ok = 0;
    for (int64_t i = 0; i < count; i++) {
        int64_t n = sqn_encode(pixels + i * in_stride, width, height,
                               channels, colorspace, qoi_compat,
                               out + i * out_stride);
        lengths[i] = n;
        if (n >= 0) ok++;
    }
    return ok;
}

/* Decode `count` streams. offsets/sizes locate each stream inside `data`.
 * Pixel outputs land at out + i*out_stride. statuses[i] = bytes written or
 * -1. Returns number of successes. */
int64_t sqn_decode_batch(const uint8_t *data, const int64_t *offsets,
                         const int64_t *sizes, int64_t count,
                         int force_channels, uint8_t *out,
                         int64_t out_stride, int64_t *statuses) {
    int64_t ok = 0;
    for (int64_t i = 0; i < count; i++) {
        uint32_t desc[5];
        int64_t n = sqn_decode(data + offsets[i], sizes[i], force_channels,
                               out + i * out_stride, desc);
        statuses[i] = n;
        if (n >= 0) ok++;
    }
    return ok;
}

/* ---- shard-boundary token scan ------------------------------------------ */

/* Partition a NON-compat stream's pixel space into n_chunks ~equal ranges
 * aligned to op starts, for the sharded large-image decoder
 * (parallel/tiled.py::decode_large_shardmap). Pure token hop: op lengths and
 * pixel counts only — no value decoding, no index table — so it runs at
 * memory speed (one tag-byte read per op), unlike a full sequential decode.
 *
 * The hop's cursor always rests at op starts with any trailing ALPHA
 * modifier already consumed (the decoder's one-byte peek, seqoia.h:777-783),
 * so every recorded boundary is a clean decoder entry point: a shard decoded
 * from it as a fresh stream differs from the global decode only by the
 * carried pixel value — an additive per-channel delta the caller fixes up on
 * the pixels before the shard's first absolute anchor.
 *
 * out must hold n_chunks*4 int64: per chunk {byte_pos, px_start,
 * first RGB/RGBA-anchor pixel (abs, -1 if none), first RGBA-anchor pixel
 * (abs, -1 if none)}. Returns 0, or -1 on malformed/compat/REF streams
 * (callers fall back to the sequential path; the reference encoder never
 * emits REF, seqoia.h §SURVEY 2.1.9). */
int64_t sqn_scan_chunks(const uint8_t *data, int64_t size, int n_chunks,
                        int64_t *out) {
    if (!data || !out || n_chunks < 1 || size < HDR_SIZE + PAD_SIZE + 1)
        return -1;
    uint32_t magic = get_be32(data);
    uint32_t width = get_be32(data + 4);
    uint32_t height = get_be32(data + 8);
    int hdr_channels = data[12];
    if (width == 0 || height == 0) return -1;
    if (hdr_channels < 1 || hdr_channels > 6) return -1;
    if (magic != MAGIC_SQOA || data[14] != START_BYTE_) return -1;
    if (height >= PIXELS_MAX_ / width) return -1;
    int colch = hdr_channels < 3 ? 1 : 3;

    int64_t p = HDR_SIZE + 1;
    int64_t chunks_len = size - PAD_SIZE;
    int64_t npx = (int64_t)width * height;
    int64_t per = (npx + n_chunks - 1) / n_chunks;
    int64_t pixel = 0;
    int c = 0;

    while (pixel < npx && p < chunks_len) {
        while (c < n_chunks && pixel >= (int64_t)c * per) {
            out[c * 4 + 0] = p;
            out[c * 4 + 1] = pixel;
            out[c * 4 + 2] = -1;
            out[c * 4 + 3] = -1;
            c++;
        }
        int b1 = data[p];
        int64_t adv, npx_op;
        int anch_r = 0, anch_a = 0;
        if (b1 < TAG_REF_LIMIT) return -1; /* REF (or stray modifier) */
        if (b1 == TAG_RGB) {
            adv = colch == 3 ? 4 : 2; npx_op = 1; anch_r = 1;
        } else if (b1 == TAG_RGBA) {
            adv = colch == 3 ? 5 : 3; npx_op = 1; anch_r = 1; anch_a = 1;
        } else if (b1 == TAG_BIGRUN) {
            adv = 1; npx_op = SQOA_MAXRUN_;
        } else if (b1 >= MASK2) { /* 11xxxxxx run */
            adv = 1; npx_op = (b1 & 0x3f) + 1;
        } else if ((b1 & MASK2) == TAG_LUMA) {
            adv = colch == 3 ? 2 : 1; npx_op = 1;
        } else {
            return -1; /* alpha-range byte at an op position: corrupt */
        }
        p += adv;
        if (colch == 3 && p < size &&
            data[p] >= TAG_ALPHA && data[p] < TAG_LUMA)
            p++; /* trailing alpha modifier */
        if (c > 0) {
            if (anch_r && out[(c - 1) * 4 + 2] < 0)
                out[(c - 1) * 4 + 2] = pixel;
            if (anch_a && out[(c - 1) * 4 + 3] < 0)
                out[(c - 1) * 4 + 3] = pixel;
        }
        pixel += npx_op;
    }
    while (c < n_chunks) { /* stream exhausted: run-fill shards */
        out[c * 4 + 0] = chunks_len;
        out[c * 4 + 1] = (int64_t)c * per < npx ? (int64_t)c * per : npx;
        out[c * 4 + 2] = -1;
        out[c * 4 + 3] = -1;
        c++;
    }
    return 0;
}

/* ---- compat INDEX-chain depth probe -------------------------------------
 *
 * One sequential pass over a color .qoi stream computing the *optimistic
 * INDEX-dependency depth*: roughly how many iterations the TPU fixpoint
 * decoder (codec/decode_compat.py) needs before every INDEX read is
 * resolved. Each op carries the depth at which its value becomes correct:
 *
 *   RGBA              -> 0            (absolute anchor, all channels)
 *   RGB               -> alpha carries: depth = depth of previous alpha
 *   DIFF / LUMA / RUN -> carries:      depth = depth of previous value
 *   INDEX reading slot k -> 1 + depth of the value last stored at k
 *
 * and every decoded op stores (value, depth) into its hash slot, exactly
 * mirroring the reference's per-pixel insert (seqoia.h:785-787; per-op is
 * equivalent, runs re-insert an identical value).
 *
 * Two depth flavors are tracked, calibrated against the measured fixpoint
 * (tests/test_compat_probe.py):
 *
 *   strict: every insert overwrites the slot depth — the nominal
 *     link-count of the dependency chain;
 *   collapsed (the returned predictor): re-inserting a value identical to
 *     the slot's current content keeps the MINIMUM depth — once any
 *     low-depth op has put the right bytes in the slot, later same-value
 *     writers cannot make a read of it later-resolving. This is what lets
 *     recurring palette colors collapse deep nominal chains (measured:
 *     small-palette content with strict depth in the hundreds converges
 *     in < 12 iterations). Exception: reads of slot 0 use the strict
 *     depth, because the fixpoint's still-unresolved guesses start at
 *     packed zero, whose hash IS slot 0 — that slot is systematically
 *     clobbered by wrong guesses until the chain feeding it resolves
 *     (this is exactly the adversarial construction in
 *     tests/test_compat_fixpoint.py).
 *
 * This is a dispatch *predictor*, not a soundness proof: wrong
 * intermediate guesses can collide into any live slot and delay
 * convergence past the prediction. Production correctness never depends
 * on it — the fixpoint's converged flags stay authoritative and
 * unconverged rows fall back to the host decoder (parallel/batch.py).
 * The probe only decides where to *try* first.
 *
 * The pass is cheaper than a decode (no pixel output traffic, no channel
 * forcing), so probing before dispatch costs a fraction of the host
 * decode it can avoid.
 *
 * out_stats (optional): {n_ops, n_index, n_px_decoded, strict_max_depth}.
 * Returns the collapsed max depth (>= 0), or -1 malformed / mono / not
 * compat.
 */
int64_t sqn_compat_probe(const uint8_t *data, int64_t size,
                         int64_t out_stats[4]) {
    if (!data || size < HDR_SIZE + PAD_SIZE) return -1;
    uint32_t magic = get_be32(data);
    uint32_t width = get_be32(data + 4);
    uint32_t height = get_be32(data + 8);
    int hdr_channels = data[12];
    if (width == 0 || height == 0) return -1;
    if (data[14] == START_BYTE_) return -1;            /* not compat */
    if (magic != MAGIC_QOIF && magic != MAGIC_SQOA) return -1;
    if (hdr_channels < 3 || hdr_channels > 6) return -1; /* color only */
    if (height >= PIXELS_MAX_ / width) return -1;

    const uint8_t *q = data + HDR_SIZE;
    const uint8_t *qend = data + size - PAD_SIZE;
    int64_t npx = (int64_t)width * height;

    uint32_t table[64];
    int64_t tds[64], tdm[64]; /* strict / collapsed slot depths */
    memset(table, 0, sizeof table);
    memset(tds, 0, sizeof tds);
    memset(tdm, 0, sizeof tdm);
    uint8_t r = 0, g = 0, b = 0, a = 255;
    int64_t ds_rgb = 0, ds_a = 0, dm_rgb = 0, dm_a = 0;
    int64_t maxd = 0, maxd_s = 0, n_ops = 0, n_index = 0, px_done = 0;

    while (px_done < npx && q < qend) {
        uint32_t b1 = *q++;
        n_ops++;
        int is_run = 0;
        if (b1 >= TAG_RUN) {
            if (b1 < TAG_RGB) { /* RUN 1..62: carries value and depths */
                px_done += (int64_t)(b1 & 0x3f);
                is_run = 1;
            } else {
                r = q[0]; g = q[1]; b = q[2];
                ds_rgb = dm_rgb = 0;
                if (b1 == TAG_RGBA) {
                    a = q[3];
                    ds_a = dm_a = 0;
                    q += 4;
                } else {
                    q += 3;
                }
            }
        } else if (b1 < 64) { /* INDEX */
            uint32_t v = table[b1];
            r = (uint8_t)v; g = (uint8_t)(v >> 8);
            b = (uint8_t)(v >> 16); a = (uint8_t)(v >> 24);
            ds_rgb = ds_a = tds[b1] + 1;
            dm_rgb = dm_a = (b1 == 0 ? tds[0] : tdm[b1]) + 1;
            n_index++;
            if (dm_rgb > maxd) maxd = dm_rgb;
            if (ds_rgb > maxd_s) maxd_s = ds_rgb;
        } else if (b1 < TAG_LUMA) { /* DIFF: carries depth */
            r = (uint8_t)(r + ((b1 >> 4) & 3) - 2);
            g = (uint8_t)(g + ((b1 >> 2) & 3) - 2);
            b = (uint8_t)(b + (b1 & 3) - 2);
        } else { /* LUMA: carries depth */
            int dg = (int)(b1 & 0x3f) - 32;
            uint32_t b2 = *q++;
            r = (uint8_t)(r + dg - 8 + ((b2 >> 4) & 15));
            g = (uint8_t)(g + dg);
            b = (uint8_t)(b + dg - 8 + (b2 & 15));
        }
        int64_t ds = ds_rgb > ds_a ? ds_rgb : ds_a;
        int64_t dm = dm_rgb > dm_a ? dm_rgb : dm_a;
        int slot = (r * 3 + g * 5 + b * 7 + a * 11) & 63;
        uint32_t v = px_pack((px_t){r, g, b, a});
        tds[slot] = ds;
        if (table[slot] != v || dm < tdm[slot]) tdm[slot] = dm;
        table[slot] = v;
        px_done++;
        (void)is_run;
    }

    if (out_stats) {
        out_stats[0] = n_ops;
        out_stats[1] = n_index;
        out_stats[2] = px_done;
        out_stats[3] = maxd_s;
    }
    return maxd;
}
