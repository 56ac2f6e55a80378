// Native host-side PCM codec + stream reblocker.
//
// Native counterpart of the reference's native sample-format layer
// (brutefir/raw2real.cpp, brutefir/real2raw.cpp, brutefir/swap.h,
// brutefir/numunion.h): the per-sample interleaved-PCM <-> planar-float
// conversion that sits on the host side of the host<->device boundary.
// Device-side scaling/dither stays in JAX (ops/formats.py, ops/dither.py);
// this library handles the byte-level work: endianness, 24-bit-in-3-byte
// packing, padded containers with bit shifts, and deinterleaving - the
// loops at raw2real.cpp:16-424 and real2raw.cpp:38-1224.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Build: make -C bfir_tpu/native

#include <cstdint>
#include <cstring>

extern "C" {

// Format codes match bfir_tpu.core.spec.SampleFormat semantics.
struct FormatDesc {
    int32_t bytes;       // container size
    int32_t sbytes;      // significant bytes
    int32_t is_float;    // 1 = IEEE float container
    int32_t big_endian;  // 1 = byte-swapped relative to little-endian host
};

static inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

// Decode interleaved raw PCM -> planar float64 [n_channels][n_frames],
// scaled to +-1.0 full scale (the input sf.scale of brutefir.cpp:435-539).
// Returns 0 on success, nonzero on unsupported format.
int bfir_decode_f64(const uint8_t* raw, double* out, int64_t n_frames,
                    int32_t n_channels, const FormatDesc* fmt) {
    const int64_t stride = (int64_t)fmt->bytes * n_channels;
    if (fmt->is_float) {
        if (fmt->bytes == 4) {
            for (int32_t c = 0; c < n_channels; ++c) {
                const uint8_t* p = raw + (int64_t)c * fmt->bytes;
                double* o = out + (int64_t)c * n_frames;
                for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                    uint32_t u;
                    std::memcpy(&u, p, 4);
                    if (fmt->big_endian) u = bswap32(u);
                    float f;
                    std::memcpy(&f, &u, 4);
                    o[i] = (double)f;
                }
            }
            return 0;
        } else if (fmt->bytes == 8) {
            for (int32_t c = 0; c < n_channels; ++c) {
                const uint8_t* p = raw + (int64_t)c * fmt->bytes;
                double* o = out + (int64_t)c * n_frames;
                for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                    uint64_t u;
                    std::memcpy(&u, p, 8);
                    if (fmt->big_endian) u = bswap64(u);
                    double d;
                    std::memcpy(&d, &u, 8);
                    o[i] = d;
                }
            }
            return 0;
        }
        return 1;
    }
    const int bits = fmt->sbytes * 8;
    const double scale = 1.0 / (double)(1u << (bits - 1));
    if (fmt->bytes == 1) {
        for (int32_t c = 0; c < n_channels; ++c) {
            const uint8_t* p = raw + c;
            double* o = out + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride)
                o[i] = (double)(int8_t)*p * scale;
        }
        return 0;
    }
    if (fmt->bytes == 2) {
        for (int32_t c = 0; c < n_channels; ++c) {
            const uint8_t* p = raw + (int64_t)c * 2;
            double* o = out + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                uint16_t u;
                std::memcpy(&u, p, 2);
                if (fmt->big_endian) u = bswap16(u);
                o[i] = (double)(int16_t)u * scale;
            }
        }
        return 0;
    }
    if (fmt->bytes == 3) {  // S24 in 3 bytes (real2raw.cpp S24 per-byte path)
        for (int32_t c = 0; c < n_channels; ++c) {
            const uint8_t* p = raw + (int64_t)c * 3;
            double* o = out + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                int32_t v;
                if (fmt->big_endian)
                    v = (p[0] << 16) | (p[1] << 8) | p[2];
                else
                    v = (p[2] << 16) | (p[1] << 8) | p[0];
                v = (v << 8) >> 8;  // sign extend from 24 bits
                o[i] = (double)v * scale;
            }
        }
        return 0;
    }
    if (fmt->bytes == 4) {  // S32 or S24-in-4 (shifted)
        const int shift = (fmt->bytes - fmt->sbytes) * 8;
        for (int32_t c = 0; c < n_channels; ++c) {
            const uint8_t* p = raw + (int64_t)c * 4;
            double* o = out + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                uint32_t u;
                std::memcpy(&u, p, 4);
                if (fmt->big_endian) u = bswap32(u);
                int32_t v = (int32_t)u >> shift;
                o[i] = (double)v * scale;
            }
        }
        return 0;
    }
    return 1;
}

// Encode already-quantized planar int32 samples -> interleaved raw bytes.
int bfir_encode_int(const int32_t* q, uint8_t* out, int64_t n_frames,
                    int32_t n_channels, const FormatDesc* fmt) {
    const int64_t stride = (int64_t)fmt->bytes * n_channels;
    if (fmt->is_float) return 1;
    if (fmt->bytes == 1) {
        for (int32_t c = 0; c < n_channels; ++c) {
            uint8_t* p = out + c;
            const int32_t* s = q + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride)
                *p = (uint8_t)(int8_t)s[i];
        }
        return 0;
    }
    if (fmt->bytes == 2) {
        for (int32_t c = 0; c < n_channels; ++c) {
            uint8_t* p = out + (int64_t)c * 2;
            const int32_t* s = q + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                uint16_t u = (uint16_t)(int16_t)s[i];
                if (fmt->big_endian) u = bswap16(u);
                std::memcpy(p, &u, 2);
            }
        }
        return 0;
    }
    if (fmt->bytes == 3) {
        for (int32_t c = 0; c < n_channels; ++c) {
            uint8_t* p = out + (int64_t)c * 3;
            const int32_t* s = q + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                uint32_t v = (uint32_t)s[i];
                if (fmt->big_endian) {
                    p[0] = (v >> 16) & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = v & 0xFF;
                } else {
                    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF;
                }
            }
        }
        return 0;
    }
    if (fmt->bytes == 4) {
        const int shift = (fmt->bytes - fmt->sbytes) * 8;
        for (int32_t c = 0; c < n_channels; ++c) {
            uint8_t* p = out + (int64_t)c * 4;
            const int32_t* s = q + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                uint32_t u = (uint32_t)(s[i] << shift);
                if (fmt->big_endian) u = bswap32(u);
                std::memcpy(p, &u, 4);
            }
        }
        return 0;
    }
    return 1;
}

// Encode planar float64 (+-1 full scale) -> interleaved float raw bytes.
int bfir_encode_float(const double* x, uint8_t* out, int64_t n_frames,
                      int32_t n_channels, const FormatDesc* fmt) {
    const int64_t stride = (int64_t)fmt->bytes * n_channels;
    if (!fmt->is_float) return 1;
    if (fmt->bytes == 4) {
        for (int32_t c = 0; c < n_channels; ++c) {
            uint8_t* p = out + (int64_t)c * 4;
            const double* s = x + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                float f = (float)s[i];
                uint32_t u;
                std::memcpy(&u, &f, 4);
                if (fmt->big_endian) u = bswap32(u);
                std::memcpy(p, &u, 4);
            }
        }
        return 0;
    }
    if (fmt->bytes == 8) {
        for (int32_t c = 0; c < n_channels; ++c) {
            uint8_t* p = out + (int64_t)c * 8;
            const double* s = x + (int64_t)c * n_frames;
            for (int64_t i = 0; i < n_frames; ++i, p += stride) {
                uint64_t u;
                std::memcpy(&u, &s[i], 8);
                if (fmt->big_endian) u = bswap64(u);
                std::memcpy(p, &u, 8);
            }
        }
        return 0;
    }
    return 1;
}

// --------------------------------------------------------------------------
// Stream reblocker: accumulates arbitrary-size chunks into fixed blocks
// (the plugin's re-block loop, foo_dsp_bfir.cpp:303-351, as a reusable
// native primitive with no per-sample Python overhead).
// --------------------------------------------------------------------------

struct Reblocker {
    double* buf;        // [n_channels][block]
    int64_t block;
    int32_t n_channels;
    int64_t fill;
};

void* bfir_reblocker_new(int64_t block, int32_t n_channels) {
    Reblocker* r = new Reblocker();
    r->buf = new double[(size_t)(block * n_channels)];
    r->block = block;
    r->n_channels = n_channels;
    r->fill = 0;
    return r;
}

void bfir_reblocker_free(void* h) {
    Reblocker* r = (Reblocker*)h;
    delete[] r->buf;
    delete r;
}

int64_t bfir_reblocker_fill(void* h) { return ((Reblocker*)h)->fill; }

void bfir_reblocker_reset(void* h) { ((Reblocker*)h)->fill = 0; }

// Push planar frames [n_channels][n_frames]; emits as many complete blocks
// as possible into out_blocks [max_blocks][n_channels][block]. Returns the
// number of complete blocks emitted. Remaining frames stay buffered.
int64_t bfir_reblocker_push(void* h, const double* frames, int64_t n_frames,
                            double* out_blocks, int64_t max_blocks) {
    Reblocker* r = (Reblocker*)h;
    int64_t emitted = 0;
    int64_t consumed = 0;
    while (consumed < n_frames && emitted < max_blocks) {
        int64_t want = r->block - r->fill;
        int64_t take = n_frames - consumed < want ? n_frames - consumed : want;
        for (int32_t c = 0; c < r->n_channels; ++c) {
            std::memcpy(r->buf + (int64_t)c * r->block + r->fill,
                        frames + (int64_t)c * n_frames + consumed,
                        (size_t)take * sizeof(double));
        }
        r->fill += take;
        consumed += take;
        if (r->fill == r->block) {
            std::memcpy(out_blocks + emitted * r->n_channels * r->block,
                        r->buf, (size_t)(r->n_channels * r->block) * sizeof(double));
            r->fill = 0;
            ++emitted;
        }
    }
    // buffer any tail beyond max_blocks capacity
    while (consumed < n_frames && r->fill < r->block) {
        int64_t take = n_frames - consumed;
        int64_t want = r->block - r->fill;
        if (take > want) take = want;
        for (int32_t c = 0; c < r->n_channels; ++c) {
            std::memcpy(r->buf + (int64_t)c * r->block + r->fill,
                        frames + (int64_t)c * n_frames + consumed,
                        (size_t)take * sizeof(double));
        }
        r->fill += take;
        consumed += take;
        if (r->fill == r->block) break;  // caller must drain first
    }
    return emitted;
}

}  // extern "C"
