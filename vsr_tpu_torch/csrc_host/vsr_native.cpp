// vsr_native — the port's NIfTI decoder for the data loader (a copy of the
// JAX package's native/vsr_native.cpp, made to decode exactly what the
// port's Python reader, io/nifti.load_nifti, decodes).
//
// zlib-gunzip + NIfTI-1 parse + conversion to float32, plus a pthread pool
// that decodes a batch of files in parallel. Python calls it through
// ctypes, which releases the interpreter lock for the whole call.
//
// Exposed C ABI:
//   int vsr_decode_nifti(const char* path, float* out, int64_t capacity,
//                        int64_t* shape7, int* ndim)
//       -> 0 on success; shape7 receives up to 7 dims and `out` the voxels
//          as float32 in the order the file stores them (x fastest). On
//          error 5 (capacity) shape7 and ndim are filled all the same, so
//          the caller can retry with a buffer of the right size.
//   int vsr_decode_batch(const char** paths, int n, float** outs,
//                        int64_t* capacities, int64_t* shapes /* n*7 */,
//                        int* ndims, int n_threads)
//       -> 0 if every file decoded, else the first error code met.
//
// Error codes: 1 open/read, 2 gunzip, 3 header (or truncated data),
// 4 dtype, 5 capacity.
//
// Scaling follows NIfTI-1 and the Python reader: scl_slope 0 or NaN means
// no scaling at all (scl_inter ignored); otherwise the data are scaled when
// slope != 1 or inter != 0 (a NaN inter counts as 0), in float32: the
// value converted to float32, times the slope, plus the intercept, each
// rounded to float32 as numpy does (build with -ffp-contract=off: no fused
// multiply-add). Little-endian files only.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

struct Header {
    int ndim;
    int64_t shape[7];
    int datatype;
    float slope, inter;
    int64_t vox_offset;
};

int parse_header(const unsigned char* buf, size_t len, Header* h) {
    if (len < 352) return 3;
    int32_t sizeof_hdr;
    std::memcpy(&sizeof_hdr, buf, 4);
    if (sizeof_hdr != 348) return 3;  // big-endian files are not decoded
    if (std::memcmp(buf + 344, "n+1", 3) != 0 &&
        std::memcmp(buf + 344, "n+2", 3) != 0) return 3;
    int16_t dim[8];
    std::memcpy(dim, buf + 40, 16);
    if (dim[0] < 1 || dim[0] > 7) return 3;
    h->ndim = dim[0];
    for (int i = 0; i < h->ndim; i++) {
        if (dim[1 + i] < 0) return 3;
        h->shape[i] = dim[1 + i];
    }
    int16_t datatype;
    std::memcpy(&datatype, buf + 70, 2);
    h->datatype = datatype;
    float vox_offset;
    std::memcpy(&vox_offset, buf + 108, 4);
    std::memcpy(&h->slope, buf + 112, 4);
    std::memcpy(&h->inter, buf + 116, 4);
    h->vox_offset = vox_offset > 0 ? (int64_t)vox_offset : 352;
    return 0;
}

template <typename T>
void convert(const unsigned char* src, float* dst, int64_t n, float slope,
             float inter, bool scale) {
    const T* s = reinterpret_cast<const T*>(src);
    if (scale) {
        for (int64_t i = 0; i < n; i++) {
            float v = (float)s[i];
            v = v * slope;
            dst[i] = v + inter;
        }
    } else {
        for (int64_t i = 0; i < n; i++) dst[i] = (float)s[i];
    }
}

int itemsize(int datatype) {
    switch (datatype) {
        case 2: case 256: return 1;
        case 4: case 512: return 2;
        case 8: case 16: case 768: return 4;
        case 64: case 1024: case 1280: return 8;
        default: return 0;
    }
}

int gunzip_file(const char* path, std::vector<unsigned char>& out) {
    gzFile f = gzopen(path, "rb");
    if (!f) return 1;
    gzbuffer(f, 1 << 20);
    out.clear();
    out.reserve(1 << 20);
    std::vector<unsigned char> chunk(1 << 18);
    int n;
    while ((n = gzread(f, chunk.data(), (unsigned)chunk.size())) > 0)
        out.insert(out.end(), chunk.data(), chunk.data() + n);
    int err = 0;
    if (n < 0) err = 2;
    gzclose(f);
    return err;
}

}  // namespace

extern "C" {

int vsr_decode_nifti(const char* path, float* out, int64_t capacity,
                     int64_t* shape7, int* ndim) {
    std::vector<unsigned char> buf;
    int err = gunzip_file(path, buf);  // handles plain files too (gzread
                                       // passes uncompressed data through)
    if (err) return err;

    Header h;
    err = parse_header(buf.data(), buf.size(), &h);
    if (err) return err;
    int size = itemsize(h.datatype);
    if (!size) return 4;

    int64_t n = 1;
    for (int i = 0; i < h.ndim; i++) n *= h.shape[i];
    for (int i = 0; i < 7; i++) shape7[i] = i < h.ndim ? h.shape[i] : 1;
    *ndim = h.ndim;
    if ((int64_t)buf.size() < h.vox_offset + n * size) return 3;
    if (n > capacity) return 5;

    const unsigned char* vox = buf.data() + h.vox_offset;
    bool has_slope = !std::isnan(h.slope) && h.slope != 0.0f;
    float inter = std::isnan(h.inter) ? 0.0f : h.inter;
    bool scale = has_slope && (h.slope != 1.0f || inter != 0.0f);
    float slope = h.slope;
    switch (h.datatype) {
        case 2:    convert<uint8_t>(vox, out, n, slope, inter, scale); break;
        case 4:    convert<int16_t>(vox, out, n, slope, inter, scale); break;
        case 8:    convert<int32_t>(vox, out, n, slope, inter, scale); break;
        case 16:   convert<float>(vox, out, n, slope, inter, scale); break;
        case 64:   convert<double>(vox, out, n, slope, inter, scale); break;
        case 256:  convert<int8_t>(vox, out, n, slope, inter, scale); break;
        case 512:  convert<uint16_t>(vox, out, n, slope, inter, scale); break;
        case 768:  convert<uint32_t>(vox, out, n, slope, inter, scale); break;
        case 1024: convert<int64_t>(vox, out, n, slope, inter, scale); break;
        case 1280: convert<uint64_t>(vox, out, n, slope, inter, scale); break;
        default: return 4;
    }
    return 0;
}

int vsr_decode_batch(const char** paths, int n, float** outs,
                     int64_t* capacities, int64_t* shapes, int* ndims,
                     int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next(0);
    std::atomic<int> first_err(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            int err = vsr_decode_nifti(paths[i], outs[i], capacities[i],
                                       shapes + (int64_t)i * 7, ndims + i);
            if (err) {
                int expected = 0;
                first_err.compare_exchange_strong(expected, err);
            }
        }
    };
    std::vector<std::thread> threads;
    int k = n_threads < n ? n_threads : n;
    for (int t = 0; t < k; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return first_err.load();
}

}  // extern "C"
