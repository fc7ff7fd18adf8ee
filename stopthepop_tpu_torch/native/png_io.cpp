// Native PNG reader/writer for dataset images (the port's copy).
//
// The same source and C ABI as the JAX package's ``native/png_io.cpp``,
// kept in the port so that the port builds and loads nothing of that
// package: ``kernels/build.py::build_host`` compiles it with the host
// compiler into ``build/torch_native/`` at first use. The datasets the
// reference's trainers read (NeRF-synthetic, MipNeRF-360) ship 8-bit PNG
// frames written with adaptive filters; this decoder turns them into dense
// u8 HxWxC buffers: PNG chunk parsing + zlib inflate + scanline unfiltering
// here, batch-parallelism across images in the Python wrapper (ctypes
// releases the GIL during the call).
//
// Supported: 8-bit depth, color types 0 (gray), 2 (RGB), 4 (gray+alpha),
// 6 (RGBA), non-interlaced. That covers every frame in the benchmark
// datasets; anything else returns ERR_FORMAT and the Python side reports it.
//
// C ABI (consumed via ctypes from stopthepop_tpu_torch/io/images.py):
//   png_read_info(path, &width, &height, &channels)
//   png_read(path, out_u8 /* H*W*C */)
//   png_write(path, data_u8, width, height, channels)
// All return 0 on success, negative error codes otherwise.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int ERR_OPEN = -1;
constexpr int ERR_HEADER = -2;
constexpr int ERR_FORMAT = -3;  // unsupported bit depth / color / interlace
constexpr int ERR_DATA = -4;    // corrupt stream / inflate failure
constexpr int ERR_IO = -5;

constexpr uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put_be32(uint8_t* p, uint32_t v) {
    p[0] = uint8_t(v >> 24);
    p[1] = uint8_t(v >> 16);
    p[2] = uint8_t(v >> 8);
    p[3] = uint8_t(v);
}

struct Info {
    uint32_t width = 0, height = 0;
    int channels = 0;
    int bit_depth = 0, color_type = 0, interlace = 0;
};

int channels_for(int color_type) {
    switch (color_type) {
        case 0: return 1;  // gray
        case 2: return 3;  // RGB
        case 4: return 2;  // gray + alpha
        case 6: return 4;  // RGBA
        default: return 0; // palette (3) and others unsupported
    }
}

// Parse the signature + IHDR; optionally collect the concatenated IDAT
// payload. Returns 0 or an error code.
int parse(const char* path, Info* info, std::vector<uint8_t>* idat) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return ERR_OPEN;
    uint8_t sig[8];
    if (std::fread(sig, 1, 8, f) != 8 || std::memcmp(sig, kSig, 8) != 0) {
        std::fclose(f);
        return ERR_HEADER;
    }
    bool saw_ihdr = false;
    int rc = 0;
    for (;;) {
        uint8_t hdr[8];
        if (std::fread(hdr, 1, 8, f) != 8) {
            rc = saw_ihdr ? ERR_DATA : ERR_HEADER;
            break;
        }
        uint32_t len = be32(hdr);
        char type[5] = {char(hdr[4]), char(hdr[5]), char(hdr[6]),
                        char(hdr[7]), 0};
        if (std::strcmp(type, "IHDR") == 0) {
            if (len != 13) { rc = ERR_HEADER; break; }
            uint8_t b[13];
            if (std::fread(b, 1, 13, f) != 13) { rc = ERR_HEADER; break; }
            info->width = be32(b);
            info->height = be32(b + 4);
            info->bit_depth = b[8];
            info->color_type = b[9];
            info->interlace = b[12];
            info->channels = channels_for(info->color_type);
            saw_ihdr = true;
            if (info->bit_depth != 8 || info->channels == 0 ||
                info->interlace != 0) {
                rc = ERR_FORMAT;
                break;
            }
            std::fseek(f, 4, SEEK_CUR);  // CRC
            if (!idat) break;            // info-only parse stops here
        } else if (std::strcmp(type, "IDAT") == 0 && idat) {
            size_t off = idat->size();
            idat->resize(off + len);
            if (std::fread(idat->data() + off, 1, len, f) != len) {
                rc = ERR_DATA;
                break;
            }
            std::fseek(f, 4, SEEK_CUR);
        } else if (std::strcmp(type, "IEND") == 0) {
            break;
        } else {
            std::fseek(f, long(len) + 4, SEEK_CUR);
        }
    }
    std::fclose(f);
    if (rc == 0 && !saw_ihdr) rc = ERR_HEADER;
    return rc;
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return (pb <= pc) ? b : c;
}

}  // namespace

extern "C" {

int png_read_info(const char* path, int* width, int* height, int* channels) {
    Info info;
    int rc = parse(path, &info, nullptr);
    if (rc != 0) return rc;
    *width = int(info.width);
    *height = int(info.height);
    *channels = info.channels;
    return 0;
}

int png_read(const char* path, uint8_t* out) {
    Info info;
    std::vector<uint8_t> idat;
    int rc = parse(path, &info, &idat);
    if (rc != 0) return rc;

    const size_t c = size_t(info.channels);
    const size_t stride = size_t(info.width) * c;   // unfiltered row bytes
    const size_t raw_size = (stride + 1) * info.height;
    std::vector<uint8_t> raw(raw_size);
    uLongf dst_len = raw_size;
    if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
        dst_len != raw_size) {
        return ERR_DATA;
    }

    // Per-scanline unfilter (filters 0-4), straight into the output buffer.
    for (size_t y = 0; y < info.height; ++y) {
        const uint8_t filter = raw[y * (stride + 1)];
        const uint8_t* src = raw.data() + y * (stride + 1) + 1;
        uint8_t* row = out + y * stride;
        const uint8_t* prev = (y > 0) ? out + (y - 1) * stride : nullptr;
        switch (filter) {
            case 0:
                std::memcpy(row, src, stride);
                break;
            case 1:  // Sub
                for (size_t x = 0; x < stride; ++x)
                    row[x] = uint8_t(src[x] + (x >= c ? row[x - c] : 0));
                break;
            case 2:  // Up
                for (size_t x = 0; x < stride; ++x)
                    row[x] = uint8_t(src[x] + (prev ? prev[x] : 0));
                break;
            case 3:  // Average
                for (size_t x = 0; x < stride; ++x) {
                    int a = x >= c ? row[x - c] : 0;
                    int b = prev ? prev[x] : 0;
                    row[x] = uint8_t(src[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (size_t x = 0; x < stride; ++x) {
                    int a = x >= c ? row[x - c] : 0;
                    int b = prev ? prev[x] : 0;
                    int d = (prev && x >= c) ? prev[x - c] : 0;
                    row[x] = uint8_t(src[x] + paeth(a, b, d));
                }
                break;
            default:
                return ERR_DATA;
        }
    }
    return 0;
}

int png_write(const char* path, const uint8_t* data, int width, int height,
              int channels) {
    int color_type;
    switch (channels) {
        case 1: color_type = 0; break;
        case 2: color_type = 4; break;
        case 3: color_type = 2; break;
        case 4: color_type = 6; break;
        default: return ERR_FORMAT;
    }
    const size_t stride = size_t(width) * channels;
    std::vector<uint8_t> raw((stride + 1) * height);
    for (int y = 0; y < height; ++y) {
        raw[y * (stride + 1)] = 0;  // filter: None
        std::memcpy(raw.data() + y * (stride + 1) + 1, data + y * stride,
                    stride);
    }
    uLongf comp_cap = compressBound(raw.size());
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
        return ERR_DATA;
    comp.resize(comp_cap);

    FILE* f = std::fopen(path, "wb");
    if (!f) return ERR_OPEN;
    auto chunk = [&](const char* type, const uint8_t* payload, uint32_t len) {
        uint8_t hdr[8];
        put_be32(hdr, len);
        std::memcpy(hdr + 4, type, 4);
        uLong crc = crc32(0L, hdr + 4, 4);
        if (len) crc = crc32(crc, payload, len);
        uint8_t crcb[4];
        put_be32(crcb, uint32_t(crc));
        return std::fwrite(hdr, 1, 8, f) == 8 &&
               (len == 0 || std::fwrite(payload, 1, len, f) == len) &&
               std::fwrite(crcb, 1, 4, f) == 4;
    };
    uint8_t ihdr[13];
    put_be32(ihdr, uint32_t(width));
    put_be32(ihdr + 4, uint32_t(height));
    ihdr[8] = 8;                    // bit depth
    ihdr[9] = uint8_t(color_type);
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    bool ok = std::fwrite(kSig, 1, 8, f) == 8 &&
              chunk("IHDR", ihdr, 13) &&
              chunk("IDAT", comp.data(), uint32_t(comp.size())) &&
              chunk("IEND", nullptr, 0);
    std::fclose(f);
    return ok ? 0 : ERR_IO;
}

}  // extern "C"
