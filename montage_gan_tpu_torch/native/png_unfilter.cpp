// Undo the row filters of an inflated 8-bit PNG image (no interlace).
//
// `src` holds `height` scanlines, each a filter byte (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth) followed by `width * channels` bytes; `channels` is 4
// (RGBA), 3 (RGB) or 1 (grey).  The reconstructed pixels are written to
// `dst` as a contiguous [height, width, 4] RGBA array; an RGB image gets
// alpha 255, a grey one its value in R, G and B and alpha 255.
// No dependencies beyond the C++ standard library; bound with ctypes by
// montage_gan_tpu_torch/utils/png.py, which releases the GIL around the call.
//
// Returns 0, or MGT_PNG_BAD_LENGTH when `src_len` is not the size the
// header gives, or MGT_PNG_BAD_FILTER + row when a row's filter byte is not
// 0-4.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int MGT_PNG_BAD_LENGTH = 1;
constexpr int MGT_PNG_BAD_FILTER = 16;

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" int mgt_png_unfilter(const uint8_t* src, long long src_len,
                                uint8_t* dst, int height, int width,
                                int channels) {
    const long long row_len = static_cast<long long>(width) * channels;
    if (src_len != static_cast<long long>(height) * (row_len + 1))
        return MGT_PNG_BAD_LENGTH;
    // the previous reconstructed row (zeros above the first) and this one
    std::vector<uint8_t> prev(row_len, 0), cur(row_len);
    const int bpp = channels;
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (row_len + 1);
        const uint8_t filter = in[0];
        ++in;
        switch (filter) {
            case 0:
                std::memcpy(cur.data(), in, row_len);
                break;
            case 1:
                for (long long i = 0; i < row_len; ++i)
                    cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
                break;
            case 2:
                for (long long i = 0; i < row_len; ++i)
                    cur[i] = in[i] + prev[i];
                break;
            case 3:
                for (long long i = 0; i < row_len; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    cur[i] = in[i] + static_cast<uint8_t>((a + prev[i]) >> 1);
                }
                break;
            case 4:
                for (long long i = 0; i < row_len; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int c = i >= bpp ? prev[i - bpp] : 0;
                    cur[i] = in[i] + paeth(a, prev[i], c);
                }
                break;
            default:
                return MGT_PNG_BAD_FILTER + y;
        }
        uint8_t* out = dst + static_cast<long long>(y) * width * 4;
        if (channels == 4) {
            std::memcpy(out, cur.data(), row_len);
        } else if (channels == 1) {
            for (int x = 0; x < width; ++x) {
                out[4 * x + 0] = out[4 * x + 1] = out[4 * x + 2] = cur[x];
                out[4 * x + 3] = 255;
            }
        } else {
            for (int x = 0; x < width; ++x) {
                out[4 * x + 0] = cur[3 * x + 0];
                out[4 * x + 1] = cur[3 * x + 1];
                out[4 * x + 2] = cur[3 * x + 2];
                out[4 * x + 3] = 255;
            }
        }
        prev.swap(cur);
    }
    return 0;
}
