// Native host I/O of the port: a threaded PNG stack decoder and the .xyz
// point-cloud writer, with the C interface and results of
// libbicos_tpu/native/fastio.cpp, built without libpng.
//
// The decoder reads each PNG itself: the signature, IHDR, the IDAT chunks
// (one run of them) and IEND, each critical chunk's CRC checked as libpng
// does by default. It inflates the image data with zlib one scanline at a
// time, undoes the five filter types and writes the row straight into the
// image's plane of one contiguous (n, H, W) buffer, on a pool of threads.
// It takes 8- and 16-bit gray and gray+alpha and 8-bit RGB and RGBA,
// non-interlaced, which is what scanners write, and gives what libpng gives
// with the reference module's transforms: alpha stripped, RGB to gray by
// png_set_rgb_to_gray_fixed(png, 1, 29900, 58700) (integer coefficients
// 9797, 19234, 3737 over 2^15, truncated, as libpng's path without gamma
// tables), 16-bit samples byte-swapped to little-endian uint16, or only
// their high byte kept in an 8-bit stack (png_set_strip_16), and 8-bit
// images widened in a 16-bit stack. The first image's depth decides the
// stack's. Every other input (palette, depths below 8, 16-bit colour,
// interlaced, a colour image with gAMA, sRGB, iCCP or cHRM, a size unlike
// the first image's, a bad CRC, a short or overlong stream) returns a
// nonzero status, and the caller decodes the files one by one.
//
// The writer formats "%g %g %g\n" lines, chunks of points on several
// threads, and writes the chunks in order.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kOpen = -1;         // the file cannot be read
constexpr int kFormat = -2;       // not a PNG, a bad CRC, a broken stream
constexpr int kSize = -3;         // another size than the first image's
constexpr int kUnsupported = -4;  // a PNG this decoder leaves to libpng

// libpng's default limits on a side, and cv::imread's on the pixel count.
constexpr uint32_t kMaxSide = 1000000;
constexpr uint64_t kMaxPixels = uint64_t(1) << 30;

const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
    return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 |
           uint32_t(p[2]) << 8 | uint32_t(p[3]);
}

struct Header {
    uint32_t width = 0, height = 0;
    int depth = 0, color = 0, interlace = 0;
};

struct Span {
    const uint8_t* data;
    uint32_t size;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp)
        return false;
    bool ok = std::fseek(fp, 0, SEEK_END) == 0;
    long size = ok ? std::ftell(fp) : -1;
    ok = size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
    if (ok) {
        out->resize(size_t(size));
        ok = std::fread(out->data(), 1, out->size(), fp) == out->size();
    }
    std::fclose(fp);
    return ok;
}

bool valid_header(const Header& h) {
    if (h.width == 0 || h.height == 0 || h.width > kMaxSide ||
        h.height > kMaxSide ||
        uint64_t(h.width) * h.height > kMaxPixels)
        return false;
    switch (h.color) {
        case 0: return h.depth == 1 || h.depth == 2 || h.depth == 4 ||
                       h.depth == 8 || h.depth == 16;
        case 3: return h.depth == 1 || h.depth == 2 || h.depth == 4 ||
                       h.depth == 8;
        case 2: case 4: case 6: return h.depth == 8 || h.depth == 16;
        default: return false;
    }
}

// The IHDR of a file that starts with the signature and an IHDR chunk.
int parse_ihdr(const uint8_t* p, size_t size, Header* h) {
    if (size < 33 || std::memcmp(p, kSignature, 8) != 0 ||
        be32(p + 8) != 13 || std::memcmp(p + 12, "IHDR", 4) != 0 ||
        uint32_t(crc32(0L, p + 12, 17)) != be32(p + 29))
        return kFormat;
    const uint8_t* d = p + 16;
    h->width = be32(d);
    h->height = be32(d + 4);
    h->depth = d[8];
    h->color = d[9];
    h->interlace = d[12];
    if (d[10] != 0 || d[11] != 0 || d[12] > 1 || !valid_header(*h))
        return kFormat;
    return kOk;
}

// Walk the chunks after IHDR: the IDAT spans in order, IEND required, each
// critical chunk's CRC checked. Colour-space chunks are noted: libpng's
// gray conversion of a colour image depends on them.
int parse_chunks(const std::vector<uint8_t>& file, Header* h,
                 std::vector<Span>* idat) {
    int rc = parse_ihdr(file.data(), file.size(), h);
    if (rc != kOk)
        return rc;
    size_t pos = 33;
    bool colour_space = false, idat_done = false;
    for (;;) {
        if (file.size() - pos < 12)
            return kFormat;  // no IEND
        const uint8_t* p = file.data() + pos;
        uint32_t len = be32(p);
        if (len > 0x7fffffffu || file.size() - pos - 12 < len)
            return kFormat;
        const uint8_t* type = p + 4;
        for (int i = 0; i < 4; i++) {
            uint8_t c = type[i] & 0xdf;
            if (c < 'A' || c > 'Z')
                return kFormat;
        }
        bool critical = (type[0] & 0x20) == 0;
        if (critical &&
            uint32_t(crc32(0L, type, len + 4)) != be32(p + 8 + len))
            return kFormat;
        if (std::memcmp(type, "IDAT", 4) == 0) {
            if (idat_done)
                return kFormat;  // a second run of IDAT chunks
            idat->push_back({p + 8, len});
        } else {
            if (!idat->empty())
                idat_done = true;
            if (std::memcmp(type, "IEND", 4) == 0)
                break;
            if (critical)
                return kUnsupported;  // PLTE, a second IHDR, unknown
            if (!std::memcmp(type, "gAMA", 4) ||
                !std::memcmp(type, "sRGB", 4) ||
                !std::memcmp(type, "iCCP", 4) ||
                !std::memcmp(type, "cHRM", 4))
                colour_space = true;
        }
        pos += size_t(len) + 12;
    }
    if (idat->empty())
        return kFormat;
    if ((h->color & 2) && colour_space)
        return kUnsupported;
    return kOk;
}

// Undo one scanline's filter in place: cur and prior are the row's bytes
// (the filter byte stripped), prior all zeros for the first row.
bool unfilter(int kind, uint8_t* cur, const uint8_t* prior, size_t n,
              size_t bpp) {
    switch (kind) {
        case 0:
            return true;
        case 1:
            for (size_t i = bpp; i < n; i++)
                cur[i] = uint8_t(cur[i] + cur[i - bpp]);
            return true;
        case 2:
            for (size_t i = 0; i < n; i++)
                cur[i] = uint8_t(cur[i] + prior[i]);
            return true;
        case 3:
            for (size_t i = 0; i < bpp; i++)
                cur[i] = uint8_t(cur[i] + (prior[i] >> 1));
            for (size_t i = bpp; i < n; i++)
                cur[i] = uint8_t(cur[i] + ((cur[i - bpp] + prior[i]) >> 1));
            return true;
        case 4:
            for (size_t i = 0; i < bpp; i++)
                cur[i] = uint8_t(cur[i] + prior[i]);
            for (size_t i = bpp; i < n; i++) {
                int a = cur[i - bpp], b = prior[i], c = prior[i - bpp];
                int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = uint8_t(cur[i] + pred);
            }
            return true;
        default:
            return false;
    }
}

// One unfiltered row to gray samples of the output's depth.
void convert_row(const Header& h, const uint8_t* row, uint8_t* out,
                 int out_depth) {
    const int channels = (h.color == 0)   ? 1
                         : (h.color == 4) ? 2
                         : (h.color == 2) ? 3
                                          : 4;
    const uint32_t w = h.width;
    if (h.depth == 16) {  // gray or gray+alpha
        const size_t step = 2 * size_t(channels);
        if (out_depth == 16) {
            uint16_t* o = reinterpret_cast<uint16_t*>(out);
            for (uint32_t x = 0; x < w; x++)
                o[x] = uint16_t(row[step * x] << 8 | row[step * x + 1]);
        } else {
            for (uint32_t x = 0; x < w; x++)
                out[x] = row[step * x];
        }
        return;
    }
    auto store = [&](uint32_t x, uint8_t v) {
        if (out_depth == 16)
            reinterpret_cast<uint16_t*>(out)[x] = v;
        else
            out[x] = v;
    };
    if (channels <= 2) {
        for (uint32_t x = 0; x < w; x++)
            store(x, row[size_t(channels) * x]);
        return;
    }
    for (uint32_t x = 0; x < w; x++) {
        const uint8_t* px = row + size_t(channels) * x;
        store(x, uint8_t((9797u * px[0] + 19234u * px[1] + 3737u * px[2])
                         >> 15));
    }
}

int decode_one(const char* path, uint8_t* out, uint32_t width,
               uint32_t height, int out_depth) {
    std::vector<uint8_t> file;
    if (!read_file(path, &file))
        return kOpen;
    Header h;
    std::vector<Span> idat;
    int rc = parse_chunks(file, &h, &idat);
    if (rc != kOk)
        return rc;
    if (h.width != width || h.height != height)
        return kSize;
    if (h.interlace || h.depth < 8 || h.color == 3 ||
        (h.depth == 16 && (h.color & 2)))
        return kUnsupported;
    const int channels = (h.color == 0)   ? 1
                         : (h.color == 4) ? 2
                         : (h.color == 2) ? 3
                                          : 4;
    const size_t bpp = size_t(channels) * (h.depth / 8);
    const size_t rowbytes = bpp * width;
    const size_t plane_row = size_t(width) * (out_depth == 16 ? 2 : 1);
    std::vector<uint8_t> a(rowbytes + 1, 0), b(rowbytes + 1, 0);
    uint8_t* prior = a.data();
    uint8_t* cur = b.data();

    z_stream z;
    std::memset(&z, 0, sizeof z);
    if (inflateInit(&z) != Z_OK)
        return kFormat;
    size_t next = 0;
    bool ended = false;
    rc = kOk;
    for (uint32_t r = 0; r < height && rc == kOk; r++) {
        z.next_out = cur;
        z.avail_out = uInt(rowbytes + 1);
        while (z.avail_out > 0) {
            if (ended) {
                rc = kFormat;  // the stream ended before the last row
                break;
            }
            if (z.avail_in == 0) {
                if (next == idat.size()) {
                    rc = kFormat;  // the data ran out
                    break;
                }
                z.next_in = const_cast<Bytef*>(idat[next].data);
                z.avail_in = idat[next].size;
                next++;
                continue;
            }
            int zr = inflate(&z, Z_NO_FLUSH);
            if (zr == Z_STREAM_END)
                ended = true;
            else if (zr != Z_OK) {
                rc = kFormat;
                break;
            }
        }
        if (rc != kOk)
            break;
        if (!unfilter(cur[0], cur + 1, prior + 1, rowbytes, bpp)) {
            rc = kFormat;
            break;
        }
        convert_row(h, cur + 1, out + plane_row * r, out_depth);
        std::swap(cur, prior);
    }
    // The stream must end right after the last row, with no data after it.
    uint8_t extra;
    while (rc == kOk && !ended) {
        if (z.avail_in == 0) {
            if (next == idat.size()) {
                rc = kFormat;
                break;
            }
            z.next_in = const_cast<Bytef*>(idat[next].data);
            z.avail_in = idat[next].size;
            next++;
            continue;
        }
        z.next_out = &extra;
        z.avail_out = 1;
        int zr = inflate(&z, Z_NO_FLUSH);
        if (zr == Z_STREAM_END && z.avail_out == 1)
            ended = true;
        else if (zr != Z_OK || z.avail_out == 0)
            rc = kFormat;
    }
    if (rc == kOk && (z.avail_in != 0 || next != idat.size()))
        rc = kFormat;
    inflateEnd(&z);
    return rc;
}

template <typename T>
void format_points(const T* pts, const float* disp, long lo, long hi,
                   bool allow_negative_z, std::string* out, long* count) {
    char line[128];
    long kept = 0;
    out->clear();
    for (long i = lo; i < hi; i++) {
        if (std::isnan(disp[i]))
            continue;
        double x = double(pts[3 * i]), y = double(pts[3 * i + 1]),
               z = double(pts[3 * i + 2]);
        if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z))
            continue;
        if (!allow_negative_z && z < 0.0)
            continue;
        int len = std::snprintf(line, sizeof line, "%g %g %g\n", x, y, z);
        out->append(line, size_t(len));
        kept++;
    }
    *count = kept;
}

int resolve_threads(int n_threads, long jobs) {
    if (n_threads <= 0) {
        n_threads = int(std::thread::hardware_concurrency());
        if (n_threads <= 0)
            n_threads = 4;
    }
    return int(std::max(1L, std::min(long(n_threads), jobs)));
}

template <typename T>
long write_xyz(const char* path, const T* pts, const float* disp, long n,
               bool allow_negative_z, int n_threads) {
    constexpr long kChunk = 1 << 16;  // points formatted by one task
    FILE* fp = std::fopen(path, "w");
    if (!fp)
        return -1;
    const long chunks = (n + kChunk - 1) / kChunk;
    const int threads = resolve_threads(n_threads, chunks);
    std::vector<std::string> text(static_cast<size_t>(threads));
    std::vector<long> counts(static_cast<size_t>(threads));
    long written = 0;
    bool ok = true;
    // Rounds of `threads` chunks: formatted together, written in order.
    for (long base = 0; base < chunks && ok; base += threads) {
        const int round = int(std::min(long(threads), chunks - base));
        auto task = [&](int t) {
            long lo = (base + t) * kChunk;
            format_points(pts, disp, lo, std::min(n, lo + kChunk),
                          allow_negative_z, &text[t], &counts[t]);
        };
        std::vector<std::thread> pool;
        for (int t = 1; t < round; t++)
            pool.emplace_back(task, t);
        task(0);
        for (auto& th : pool)
            th.join();
        for (int t = 0; t < round && ok; t++) {
            ok = std::fwrite(text[t].data(), 1, text[t].size(), fp) ==
                 text[t].size();
            written += counts[t];
        }
    }
    if (std::fclose(fp) != 0 || !ok)
        return -1;
    return written;
}

}  // namespace

extern "C" {

// The first image's width, height and bit depth: 0, or a negative status.
int bicos_png_probe(const char* path, int* width, int* height,
                    int* bitdepth) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp)
        return kOpen;
    uint8_t head[33];
    size_t got = std::fread(head, 1, sizeof head, fp);
    std::fclose(fp);
    Header h;
    int rc = parse_ihdr(head, got, &h);
    if (rc != kOk)
        return rc;
    *width = int(h.width);
    *height = int(h.height);
    *bitdepth = h.depth;
    return kOk;
}

// Decode n PNGs into one contiguous (n, height, width) buffer of uint8
// (out_bitdepth 8) or little-endian uint16 (16) on n_threads threads (0:
// one per core), at most n. Returns 0, or the status of a failing image.
int bicos_decode_stack(const char** paths, int n, int width, int height,
                       int out_bitdepth, uint8_t* out, int n_threads) {
    if (n <= 0 || width <= 0 || height <= 0 ||
        (out_bitdepth != 8 && out_bitdepth != 16))
        return kFormat;
    const int threads = resolve_threads(n_threads, n);
    const size_t plane =
        size_t(width) * size_t(height) * (out_bitdepth == 16 ? 2 : 1);
    std::atomic<int> next(0), status(kOk);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n || status.load() != kOk)
                return;
            int rc = decode_one(paths[i], out + plane * size_t(i),
                                uint32_t(width), uint32_t(height),
                                out_bitdepth);
            if (rc != kOk)
                status.store(rc);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < threads; t++)
        pool.emplace_back(worker);
    worker();
    for (auto& th : pool)
        th.join();
    return status.load();
}

// The .xyz writer: a "%g %g %g\n" line for each point whose disparity is
// not NaN (the caller folds int16 -32768 into NaN), whose coordinates are
// finite and whose z is not negative unless allow_negative_z (z == 0 is
// kept). points: (n, 3) float32, or float64 when f64 is set. Returns the
// number of points written, or -1 on an I/O error.
long bicos_write_xyz(const char* path, const void* points, const float* disp,
                     long n, int allow_negative_z, int f64, int n_threads) {
    if (f64)
        return write_xyz(path, static_cast<const double*>(points), disp, n,
                         allow_negative_z != 0, n_threads);
    return write_xyz(path, static_cast<const float*>(points), disp, n,
                     allow_negative_z != 0, n_threads);
}

}  // extern "C"
