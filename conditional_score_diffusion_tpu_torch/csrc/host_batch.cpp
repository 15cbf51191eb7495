// host_batch: uint8 HWC images -> one float32 [0, 1] NHWC batch on the host,
// with an optional horizontal flip per image and an integer nearest-neighbour
// upsample (the JAX package's native/csdt_native.cpp, with a plain C
// interface in place of the CPython C API).
//
// Each value is v / 255.0f, an IEEE division (the build has no fast-math)
// made once per byte value into a table, so the batch equals numpy's
// `im.astype(np.float32) / 255.0` bit for bit.
// (The JAX extension multiplies by 1.0f / 255.0f, one ulp off numpy for
// some values.)  Images are spread over `n_threads` std::threads (the
// caller picks one per 16 MiB of output: the copy is bound by memory, and
// threads cost more than they save on a smaller batch); the caller (ctypes)
// has released the interpreter lock.
//
// Built by conditional_score_diffusion_tpu_torch/data/native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread host_batch.cpp -o libhost_batch-<digest>.so

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// v / 255.0f for every byte value v: the same IEEE quotients, divided once.
struct Levels {
    float v[256];
    Levels() {
        for (int i = 0; i < 256; ++i) v[i] = static_cast<float>(i) / 255.0f;
    }
};
const Levels kLevels;

void convert_one(const uint8_t* src, float* dst, int H, int W, int C, int up, bool flip) {
    const size_t row = static_cast<size_t>(W) * up * C;  // floats in one output row
    for (int h = 0; h < H; ++h) {
        float* d0 = dst + static_cast<size_t>(h) * up * row;
        for (int w = 0; w < W; ++w) {
            const uint8_t* s = src + (static_cast<size_t>(h) * W + (flip ? W - 1 - w : w)) * C;
            float* d = d0 + static_cast<size_t>(w) * up * C;
            for (int dx = 0; dx < up; ++dx)
                for (int c = 0; c < C; ++c) d[dx * C + c] = kLevels.v[s[c]];
        }
        for (int dy = 1; dy < up; ++dy)  // the other up - 1 rows repeat the first
            for (size_t i = 0; i < row; ++i) d0[dy * row + i] = d0[i];
    }
}

}  // namespace

extern "C" {

// srcs: B pointers to H*W*C uint8 images; flips: B bytes (nonzero: flip) or
// null; out: B*(H*up)*(W*up)*C floats.  Returns 0, or -1 on bad sizes.
int csdt_assemble_batch(const uint8_t* const* srcs, int B, int H, int W, int C, int up,
                        const uint8_t* flips, float* out, int n_threads) {
    if (B < 0 || H <= 0 || W <= 0 || C <= 0 || up <= 0 || n_threads <= 0) return -1;
    const size_t per_image = static_cast<size_t>(H) * up * W * up * C;
    std::atomic<int> next{0};
    auto worker = [&]() {
        for (int i = next.fetch_add(1); i < B; i = next.fetch_add(1))
            convert_one(srcs[i], out + per_image * i, H, W, C, up, flips != nullptr && flips[i] != 0);
    };
    const int n = n_threads < B ? n_threads : B;
    if (n <= 1) {
        worker();
        return 0;
    }
    std::vector<std::thread> pool;
    pool.reserve(n);
    for (int t = 0; t < n; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
