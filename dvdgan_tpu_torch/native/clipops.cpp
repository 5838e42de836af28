// Native host-side clip assembly for the input pipeline: a copy of
// dvdgan_tpu/native/clipops.cpp's clip_window_f32 (the port imports
// nothing of dvdgan_tpu; the reference's batched entry, which nothing
// calls, is left out).
//
// The reference's DataLoader does decode → crop → resize → normalize in
// Python/PIL per frame ([R dataset.py]); the host has to keep the
// accelerator fed, so the per-frame pixel work here is a single fused
// C++ pass: window-select + center-crop + nearest-resize + [0,255]→[-1,1]
// normalize, parallelized over frames with std::thread. Exposed as a plain
// C ABI consumed via ctypes (no pybind11 in this environment).
//
// Layouts match the Python pipeline: input uint8 (T0, H, W, 3) row-major,
// output float32 (T, S, S, 3) in [-1, 1].

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

void process_frame(const uint8_t* src, float* dst, int H, int W, int S,
                   int y0, int x0, int s, const int* idx) {
    // src: one (H, W, 3) frame; dst: one (S, S, 3) frame.
    // 256-entry LUT keeps the normalize exact at the endpoints
    // (255 → 1.0f, 0 → -1.0f) and hoists the divide out of the pixel loop.
    float lut[256];
    for (int v = 0; v < 256; ++v) lut[v] = (2.0f * v) / 255.0f - 1.0f > 1.0f
        ? 1.0f : (2.0f * v) / 255.0f - 1.0f;
    lut[255] = 1.0f;
    for (int oy = 0; oy < S; ++oy) {
        const uint8_t* row = src + ((y0 + idx[oy]) * (int64_t)W + x0) * 3;
        float* orow = dst + oy * (int64_t)S * 3;
        for (int ox = 0; ox < S; ++ox) {
            const uint8_t* p = row + idx[ox] * 3;
            orow[ox * 3 + 0] = lut[p[0]];
            orow[ox * 3 + 1] = lut[p[1]];
            orow[ox * 3 + 2] = lut[p[2]];
        }
    }
}

}  // namespace

extern "C" {

// Assemble one training clip.
//   frames: (T0, H, W, 3) uint8; out: (T, S, S, 3) float32.
//   start:  first frame of the window (frames wrap modulo T0, which also
//           implements the short-clip loop-padding of the Python path).
//   y0,x0,s: center-crop square; S: output size; n_threads: frame-level
//           parallelism (<=0 → hardware_concurrency).
void clip_window_f32(const uint8_t* frames, int T0, int H, int W,
                     float* out, int T, int S, int start,
                     int y0, int x0, int s, int n_threads) {
    // nearest-neighbor index map (matches numpy: floor(arange(S) * s / S))
    std::vector<int> idx(S);
    for (int i = 0; i < S; ++i) {
        idx[i] = std::min((int)((int64_t)i * s / S), s - 1);
    }

    const int64_t in_frame = (int64_t)H * W * 3;
    const int64_t out_frame = (int64_t)S * S * 3;

    auto work = [&](int t_begin, int t_end) {
        for (int t = t_begin; t < t_end; ++t) {
            int src_t = (start + t) % T0;
            process_frame(frames + src_t * in_frame, out + t * out_frame,
                          H, W, S, y0, x0, s, idx.data());
        }
    };

    int hw = (int)std::thread::hardware_concurrency();
    int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
    nt = std::max(1, std::min(nt, T));
    if (nt == 1) {
        work(0, T);
        return;
    }
    std::vector<std::thread> pool;
    int per = (T + nt - 1) / nt;
    for (int i = 0; i < nt; ++i) {
        int b = i * per, e = std::min(T, b + per);
        if (b >= e) break;
        pool.emplace_back(work, b, e);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
