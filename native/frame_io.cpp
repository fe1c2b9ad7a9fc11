// Native frame IO: point rasterizer + PNG encoder + legacy-binary VTK.
//
// This framework's equivalent of the reference's native output stack — the
// Canvas software rasterizer (cpp_validation/taichi.h:16581-16920), the
// bundled stb_image_write PNG encoder (taichi.h:24860-26238, used via
// Array2D::write_as_image :30346-30390), and the per-frame VTK particle
// export implied by exec.py:29's post_process artifacts.  The Python
// fallbacks (utils/render.py, utils/io_vtk.py) stay authoritative for
// semantics; this library exists because per-frame IO at 1M+ particles
// is wall-clock that the Python string/PIL path spends on the critical
// path of the production run (measured: post_process ~0.6 s/frame at 1M
// = ~25% of the reference-workload wall time).
//
// Exact-match contract with utils/render.rasterize: same f32 pixel
// arithmetic (x/extent*res, clip, truncate), same offset-major overwrite
// order (for each (dy, dx) stencil offset: for each particle ascending),
// so a pixel-equality test can pin the two implementations together.
//
// Build: make -C native  (links -lz for deflate + crc32).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

#include <zlib.h>

namespace {

inline void put_be32(std::vector<unsigned char>& v, uint32_t x) {
    v.push_back((x >> 24) & 0xFF);
    v.push_back((x >> 16) & 0xFF);
    v.push_back((x >> 8) & 0xFF);
    v.push_back(x & 0xFF);
}

// One PNG chunk: length, tag, payload, CRC32(tag + payload).
void png_chunk(std::vector<unsigned char>& out, const char tag[4],
               const unsigned char* data, size_t len) {
    put_be32(out, static_cast<uint32_t>(len));
    size_t tag_at = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + len);
    uLong crc = crc32(0L, out.data() + tag_at, static_cast<uInt>(len + 4));
    put_be32(out, static_cast<uint32_t>(crc));
}

}  // namespace

extern "C" {

// Rasterize n 2D points into an RGB image and encode a PNG.
//   xy      : (n, 2) f32 domain coordinates in [0, extent]^2
//   colors  : (n, 3) u8 per-particle RGB
//   res     : square image resolution
//   radius  : pixel radius of the particle stamp (circle mask)
//   bg_rgb  : 0xRRGGBB background
// Returns 0 on success, negative on IO/encode failure.
int mpm_frame_png(const char* path, const float* xy,
                  const unsigned char* colors, long long n, int res,
                  float extent, int radius, unsigned bg_rgb) {
    const int W = res, H = res;
    std::vector<unsigned char> img(static_cast<size_t>(W) * H * 3);
    const unsigned char bg[3] = {
        static_cast<unsigned char>((bg_rgb >> 16) & 0xFF),
        static_cast<unsigned char>((bg_rgb >> 8) & 0xFF),
        static_cast<unsigned char>(bg_rgb & 0xFF),
    };
    for (size_t p = 0; p < img.size(); p += 3) {
        img[p] = bg[0];
        img[p + 1] = bg[1];
        img[p + 2] = bg[2];
    }
    // Pixel coordinates, f32 arithmetic identical to render.rasterize:
    // px = clip(x/extent*res, 0, res-1) truncated; py flips the y axis.
    std::vector<int> pxs(n), pys(n);
    const float resf = static_cast<float>(res);
    const float top = static_cast<float>(res - 1);
    for (long long i = 0; i < n; i++) {
        float fx = (xy[2 * i] / extent) * resf;
        float fy = (1.0f - xy[2 * i + 1] / extent) * resf;
        fx = fx < 0.0f ? 0.0f : (fx > top ? top : fx);
        fy = fy < 0.0f ? 0.0f : (fy > top ? top : fy);
        pxs[i] = static_cast<int>(fx);
        pys[i] = static_cast<int>(fy);
    }
    // Offset-major particle stamping — the same overwrite order as the
    // NumPy fancy-assignment loop (last write per (dy, dx) pass wins).
    for (int dy = -radius; dy <= radius; dy++) {
        for (int dx = -radius; dx <= radius; dx++) {
            if (dx * dx + dy * dy > radius * radius) continue;
            for (long long i = 0; i < n; i++) {
                int ix = pxs[i] + dx;
                int iy = pys[i] + dy;
                ix = ix < 0 ? 0 : (ix >= W ? W - 1 : ix);
                iy = iy < 0 ? 0 : (iy >= H ? H - 1 : iy);
                unsigned char* px = &img[(static_cast<size_t>(iy) * W + ix) * 3];
                px[0] = colors[3 * i];
                px[1] = colors[3 * i + 1];
                px[2] = colors[3 * i + 2];
            }
        }
    }
    // Raw scanlines with filter byte 0, then one zlib stream (level 1:
    // frame dumps are write-bound; compression ratio is secondary).
    std::vector<unsigned char> raw(static_cast<size_t>(H) * (1 + W * 3));
    for (int y = 0; y < H; y++) {
        unsigned char* row = &raw[static_cast<size_t>(y) * (1 + W * 3)];
        row[0] = 0;
        std::memcpy(row + 1, &img[static_cast<size_t>(y) * W * 3], W * 3);
    }
    uLongf zcap = compressBound(static_cast<uLong>(raw.size()));
    std::vector<unsigned char> z(zcap);
    if (compress2(z.data(), &zcap, raw.data(),
                  static_cast<uLong>(raw.size()), 1) != Z_OK) {
        return -2;
    }
    std::vector<unsigned char> out;
    out.reserve(zcap + 128);
    static const unsigned char sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    out.insert(out.end(), sig, sig + 8);
    unsigned char ihdr[13];
    ihdr[0] = (W >> 24) & 0xFF; ihdr[1] = (W >> 16) & 0xFF;
    ihdr[2] = (W >> 8) & 0xFF;  ihdr[3] = W & 0xFF;
    ihdr[4] = (H >> 24) & 0xFF; ihdr[5] = (H >> 16) & 0xFF;
    ihdr[6] = (H >> 8) & 0xFF;  ihdr[7] = H & 0xFF;
    ihdr[8] = 8;   // bit depth
    ihdr[9] = 2;   // color type: truecolor RGB
    ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
    png_chunk(out, "IHDR", ihdr, 13);
    png_chunk(out, "IDAT", z.data(), zcap);
    png_chunk(out, "IEND", nullptr, 0);
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return wrote == out.size() ? 0 : -1;
}

// Legacy BINARY VTK POLYDATA particle export: POINTS (f32 big-endian,
// zero-padded to 3D) + VERTICES.  Readable by ParaView; parsed back by
// utils/io_vtk.read_vtk_points.
int mpm_vtk_particles(const char* path, const float* x, long long n,
                      int dim) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f,
                 "# vtk DataFile Version 3.0\n"
                 "mpm_flip98a_tpu particles\n"
                 "BINARY\n"
                 "DATASET POLYDATA\n"
                 "POINTS %lld float\n",
                 n);
    std::vector<unsigned char> buf(static_cast<size_t>(n) * 12);
    for (long long i = 0; i < n; i++) {
        for (int d = 0; d < 3; d++) {
            float v = d < dim ? x[i * dim + d] : 0.0f;
            uint32_t u;
            std::memcpy(&u, &v, 4);
            unsigned char* p = &buf[(static_cast<size_t>(i) * 3 + d) * 4];
            p[0] = (u >> 24) & 0xFF;
            p[1] = (u >> 16) & 0xFF;
            p[2] = (u >> 8) & 0xFF;
            p[3] = u & 0xFF;
        }
    }
    std::fwrite(buf.data(), 1, buf.size(), f);
    std::fprintf(f, "\nVERTICES %lld %lld\n", n, 2 * n);
    std::vector<unsigned char> vert(static_cast<size_t>(n) * 8);
    for (long long i = 0; i < n; i++) {
        unsigned char* p = &vert[static_cast<size_t>(i) * 8];
        p[0] = 0; p[1] = 0; p[2] = 0; p[3] = 1;  // count = 1, BE
        uint32_t u = static_cast<uint32_t>(i);
        p[4] = (u >> 24) & 0xFF;
        p[5] = (u >> 16) & 0xFF;
        p[6] = (u >> 8) & 0xFF;
        p[7] = u & 0xFF;
    }
    std::fwrite(vert.data(), 1, vert.size(), f);
    std::fputc('\n', f);
    std::fclose(f);
    return 0;
}

}  // extern "C"
