// Native PLY reader/writer for 3DGS Gaussian point clouds (the port's copy).
//
// The same source and C ABI as the JAX package's ``native/ply_io.cpp``,
// kept in the port so that the port builds and loads nothing of that
// package: ``kernels/build.py::build_host`` compiles it with the host
// compiler into ``build/torch_native/`` at first use. The reference
// ecosystem stores trained Gaussian models as binary-little-endian PLY
// files with an all-float32 vertex element (x, y, z, nx, ny, nz, f_dc_*,
// f_rest_*, opacity, scale_*, rot_*). This loader streams such files into a
// dense row-major [N, P] float32 buffer with multithreaded pread, and
// writes them back.
//
// C ABI (consumed via ctypes from stopthepop_tpu_torch/io/ply.py):
//   ply_read_header(path, names_buf, names_cap, &n_verts, &n_props, &offset)
//   ply_read_data(path, offset, n_verts, n_props, out, n_threads)
//   ply_write(path, names, n_verts, n_props, data)
// All return 0 on success, negative error codes otherwise.

#include <algorithm>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <unistd.h>
#include <string>
#include <sstream>
#include <thread>
#include <vector>

namespace {

constexpr int ERR_OPEN = -1;
constexpr int ERR_HEADER = -2;
constexpr int ERR_FORMAT = -3;     // not binary_little_endian / non-float prop
constexpr int ERR_BUF = -4;        // names buffer too small
constexpr int ERR_IO = -5;
constexpr int ERR_WRITE = -6;

struct Header {
    long n_verts = -1;
    std::vector<std::string> names;
    long data_offset = 0;
    bool little_endian = false;
};

int parse_header(FILE* f, Header* h) {
    char line[4096];
    if (!fgets(line, sizeof line, f) || strncmp(line, "ply", 3) != 0)
        return ERR_HEADER;
    bool in_vertex = false;
    while (fgets(line, sizeof line, f)) {
        std::istringstream ss(line);
        std::string tok;
        ss >> tok;
        if (tok == "format") {
            std::string fmt;
            ss >> fmt;
            h->little_endian = (fmt == "binary_little_endian");
        } else if (tok == "element") {
            std::string name;
            long count;
            ss >> name >> count;
            in_vertex = (name == "vertex");
            if (in_vertex) h->n_verts = count;
            else if (h->n_verts >= 0) return ERR_FORMAT;  // trailing elements
        } else if (tok == "property" && in_vertex) {
            std::string type, name;
            ss >> type >> name;
            if (type != "float" && type != "float32") return ERR_FORMAT;
            h->names.push_back(name);
        } else if (tok == "end_header") {
            h->data_offset = ftell(f);
            return (h->little_endian && h->n_verts >= 0 && !h->names.empty())
                       ? 0 : ERR_FORMAT;
        }
    }
    return ERR_HEADER;
}

}  // namespace

extern "C" {

int ply_read_header(const char* path, char* names_buf, long names_cap,
                    long* n_verts, int* n_props, long* data_offset) {
    FILE* f = fopen(path, "rb");
    if (!f) return ERR_OPEN;
    Header h;
    int rc = parse_header(f, &h);
    fclose(f);
    if (rc != 0) return rc;
    std::string joined;
    for (size_t i = 0; i < h.names.size(); ++i) {
        if (i) joined += '\n';
        joined += h.names[i];
    }
    if ((long)joined.size() + 1 > names_cap) return ERR_BUF;
    memcpy(names_buf, joined.c_str(), joined.size() + 1);
    *n_verts = h.n_verts;
    *n_props = (int)h.names.size();
    *data_offset = h.data_offset;
    return 0;
}

int ply_read_data(const char* path, long data_offset, long n_verts,
                  int n_props, float* out, int n_threads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return ERR_OPEN;
    const long total_bytes = n_verts * (long)n_props * 4;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    // Chunk on vertex boundaries so rows stay contiguous per thread.
    std::vector<std::thread> ts;
    std::vector<int> rcs(n_threads, 0);
    const long verts_per = (n_verts + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        ts.emplace_back([=, &rcs] {
            const long v0 = t * verts_per;
            if (v0 >= n_verts) return;
            const long v1 = std::min(n_verts, v0 + verts_per);
            long off = data_offset + v0 * (long)n_props * 4;
            char* dst = (char*)out + v0 * (long)n_props * 4;
            long remaining = (v1 - v0) * (long)n_props * 4;
            while (remaining > 0) {
                ssize_t got = pread(fd, dst, remaining, off);
                if (got <= 0) { rcs[t] = ERR_IO; return; }
                dst += got;
                off += got;
                remaining -= got;
            }
        });
    }
    for (auto& th : ts) th.join();
    close(fd);
    (void)total_bytes;
    for (int rc : rcs) if (rc != 0) return rc;
    return 0;
}

int ply_write(const char* path, const char* names, long n_verts, int n_props,
              const float* data) {
    FILE* f = fopen(path, "wb");
    if (!f) return ERR_OPEN;
    fprintf(f, "ply\nformat binary_little_endian 1.0\n");
    fprintf(f, "element vertex %ld\n", n_verts);
    // names: '\n'-joined property names
    const char* p = names;
    for (int i = 0; i < n_props; ++i) {
        const char* e = strchr(p, '\n');
        size_t len = e ? (size_t)(e - p) : strlen(p);
        fprintf(f, "property float %.*s\n", (int)len, p);
        p += len + (e ? 1 : 0);
    }
    fprintf(f, "end_header\n");
    size_t count = (size_t)n_verts * n_props;
    size_t written = fwrite(data, 4, count, f);
    fclose(f);
    return written == count ? 0 : ERR_WRITE;
}

}  // extern "C"
