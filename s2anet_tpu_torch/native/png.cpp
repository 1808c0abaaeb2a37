// PNG row unfiltering (PNG specification, section 9) for the port's image
// reader, s2anet_tpu_torch/data/image.py. The Sub, Average and Paeth filters
// depend on the pixel to the left, so a row is serial: this loop replaces the
// NumPy one, which takes minutes on a 4000 x 4000 scene.
#include <cstdint>
#include <cstdlib>

extern "C" {

// src: h rows of (1 + row_bytes) bytes, each a filter-type byte then the
// filtered row; dst: h x row_bytes unfiltered bytes. bpp: bytes per complete
// pixel (at least 1). Returns 0, or -(r + 1) where row r has a filter type
// above 4.
int64_t png_unfilter(const uint8_t* src, int64_t h, int64_t row_bytes,
                     int64_t bpp, uint8_t* dst) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* f = src + r * (row_bytes + 1);
        const uint8_t type = f[0];
        ++f;
        uint8_t* out = dst + r * row_bytes;
        const uint8_t* up = r > 0 ? out - row_bytes : nullptr;
        switch (type) {
        case 0:
            for (int64_t x = 0; x < row_bytes; ++x) out[x] = f[x];
            break;
        case 1:
            for (int64_t x = 0; x < row_bytes; ++x)
                out[x] = uint8_t(f[x] + (x >= bpp ? out[x - bpp] : 0));
            break;
        case 2:
            for (int64_t x = 0; x < row_bytes; ++x)
                out[x] = uint8_t(f[x] + (up ? up[x] : 0));
            break;
        case 3:
            for (int64_t x = 0; x < row_bytes; ++x) {
                const int a = x >= bpp ? out[x - bpp] : 0;
                const int b = up ? up[x] : 0;
                out[x] = uint8_t(f[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < row_bytes; ++x) {
                const int a = x >= bpp ? out[x - bpp] : 0;
                const int b = up ? up[x] : 0;
                const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                const int p = a + b - c;
                const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[x] = uint8_t(f[x] + pred);
            }
            break;
        default:
            return -(r + 1);
        }
    }
    return 0;
}

}  // extern "C"
