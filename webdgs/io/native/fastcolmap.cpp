// Native COLMAP binary parsers.
//
// The reference parses these formats with per-point JavaScript DataView
// loops (src/utils/load-pointcloud.ts:85-141, load-camera.ts:170-238).  The
// Python fallback mirrors that; this C++ path exists for production-size
// inputs (millions of points3D records with variable-length tracks), where
// an interpreted per-record loop is seconds-to-minutes.  Bound via ctypes
// (no pybind11 in the image); see webdgs/io/native/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// points3D.bin: [u64 n] then per point:
//   u64 id, 3*f64 xyz, 3*u8 rgb, f64 error, u64 track_len, track_len*8 bytes
// Fills xyz (n,3) f32 and rgb (n,3) f32 in [0,1].  Returns the number of
// points parsed, or -1 on malformed input.
int64_t parse_points3d(const uint8_t* data, int64_t size, float* xyz,
                       float* rgb, int64_t capacity) {
    if (size < 8) return -1;
    uint64_t n;
    std::memcpy(&n, data, 8);
    const uint8_t* p = data + 8;
    const uint8_t* end = data + size;
    int64_t count = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if (p + 51 > end || count >= capacity) return -1;
        double v[3];
        std::memcpy(v, p + 8, 24);
        xyz[count * 3 + 0] = static_cast<float>(v[0]);
        xyz[count * 3 + 1] = static_cast<float>(v[1]);
        xyz[count * 3 + 2] = static_cast<float>(v[2]);
        rgb[count * 3 + 0] = p[32] / 255.0f;
        rgb[count * 3 + 1] = p[33] / 255.0f;
        rgb[count * 3 + 2] = p[34] / 255.0f;
        uint64_t track_len;
        std::memcpy(&track_len, p + 43, 8);
        // bounds-check before advancing: a corrupt huge track_len would
        // overflow the pointer arithmetic and bypass the p > end check
        if (track_len > static_cast<uint64_t>(end - p - 51) / 8) return -1;
        p += 51 + track_len * 8;
        ++count;
    }
    return count;
}

// images.bin: [u64 n] then per image:
//   u32 id, 4*f64 quat wxyz, 3*f64 tvec, u32 camera_id,
//   null-terminated name, u64 npts2d, npts2d*24 bytes
// Fills ids (n,), qvecs (n,4) f64, tvecs (n,3) f64, camera_ids (n,),
// names: concatenated null-terminated strings into name_buf, with
// name_offsets (n,) start indices.  Returns image count or -1.
int64_t parse_images_bin(const uint8_t* data, int64_t size, int32_t* ids,
                         double* qvecs, double* tvecs, int32_t* camera_ids,
                         char* name_buf, int64_t name_buf_size,
                         int64_t* name_offsets, int64_t capacity) {
    if (size < 8) return -1;
    uint64_t n;
    std::memcpy(&n, data, 8);
    const uint8_t* p = data + 8;
    const uint8_t* end = data + size;
    int64_t name_pos = 0;
    int64_t count = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if (p + 64 > end || count >= capacity) return -1;
        uint32_t image_id;
        std::memcpy(&image_id, p, 4);
        std::memcpy(qvecs + count * 4, p + 4, 32);
        std::memcpy(tvecs + count * 3, p + 36, 24);
        uint32_t camera_id;
        std::memcpy(&camera_id, p + 60, 4);
        p += 64;
        name_offsets[count] = name_pos;
        while (p < end && *p != 0) {
            if (name_pos + 1 >= name_buf_size) return -1;
            name_buf[name_pos++] = static_cast<char>(*p++);
        }
        if (p >= end) return -1;
        name_buf[name_pos++] = '\0';
        ++p;  // consume the terminator
        if (p + 8 > end) return -1;
        uint64_t npts;
        std::memcpy(&npts, p, 8);
        if (npts > static_cast<uint64_t>(end - p - 8) / 24) return -1;
        p += 8 + npts * 24;
        ids[count] = static_cast<int32_t>(image_id);
        camera_ids[count] = static_cast<int32_t>(camera_id);
        ++count;
    }
    return count;
}

}  // extern "C"
