// Software z-buffer rasterizer for dataset preprocessing (counterpart of
// panst3r_tpu/native/rasterizer.cpp; host code, not a kernel of the card).
//
// Takes the place of an offscreen OpenGL renderer with a
// no-anti-aliasing instance-mask shader.
// Renders per-pixel depth and integer instance labels from a labeled mesh:
// flat shading, one label per face, no anti-aliasing (anti-aliased label
// edges would corrupt the ids).
//
// Built at first use by g++ into the git-ignored panst3r_torch/_build/ and
// called through ctypes (panst3r_torch/native/__init__.py::rasterize_mesh);
// a numpy version (_rasterize_numpy) runs on a machine with no compiler.

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// verts: (n_verts, 3) float32 camera-space (OpenCV convention: +z forward)
// faces: (n_faces, 3) int32 vertex indices
// face_labels: (n_faces,) int32 instance/semantic label per face
// K: 3x3 row-major intrinsics
// depth_out: (H*W,) float32, 0 = empty
// label_out: (H*W,) int32, 0 = empty
void rasterize_mesh(const float* verts, int64_t n_verts,
                    const int32_t* faces, int64_t n_faces,
                    const int32_t* face_labels,
                    const float* K, int32_t H, int32_t W,
                    float* depth_out, int32_t* label_out) {
    const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];

    for (int64_t f = 0; f < n_faces; ++f) {
        const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                      i2 = faces[3 * f + 2];
        if (i0 >= n_verts || i1 >= n_verts || i2 >= n_verts) continue;
        const float* v0 = verts + 3 * i0;
        const float* v1 = verts + 3 * i1;
        const float* v2 = verts + 3 * i2;
        const float z0 = v0[2], z1 = v1[2], z2 = v2[2];
        if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue;  // clip

        const float x0 = fx * v0[0] / z0 + cx, y0 = fy * v0[1] / z0 + cy;
        const float x1 = fx * v1[0] / z1 + cx, y1 = fy * v1[1] / z1 + cy;
        const float x2 = fx * v2[0] / z2 + cx, y2 = fy * v2[1] / z2 + cy;

        const int xmin = std::max(0, (int)std::floor(
            std::min(x0, std::min(x1, x2))));
        const int xmax = std::min((int)W - 1, (int)std::ceil(
            std::max(x0, std::max(x1, x2))));
        const int ymin = std::max(0, (int)std::floor(
            std::min(y0, std::min(y1, y2))));
        const int ymax = std::min((int)H - 1, (int)std::ceil(
            std::max(y0, std::max(y1, y2))));
        if (xmin > xmax || ymin > ymax) continue;

        const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
        if (std::fabs(area) < 1e-12f) continue;   // degenerate
        const float inv_area = 1.0f / area;
        // Perspective-correct: interpolate 1/z with barycentrics.
        const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;
        const int32_t label = face_labels[f];

        for (int y = ymin; y <= ymax; ++y) {
            for (int x = xmin; x <= xmax; ++x) {
                const float px = (float)x + 0.5f, py = (float)y + 0.5f;
                float w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py))
                           * inv_area;
                float w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py))
                           * inv_area;
                float w2 = 1.0f - w0 - w1;
                // No face culling: accept both
                // orientations by sign-normalized barycentrics.
                if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) continue;
                const float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
                const float z = 1.0f / iz;
                float* dp = depth_out + (int64_t)y * W + x;
                if (*dp == 0.0f || z < *dp) {
                    *dp = z;
                    label_out[(int64_t)y * W + x] = label;
                }
            }
        }
    }
}

}  // extern "C"
