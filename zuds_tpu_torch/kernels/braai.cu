// H13: one convolution layer of the braai real/bogus CNN, and its training
// mode H13t; H19: the layer's input gradient; H20: its weight and bias
// gradient.
//
// H13 replaces the four nn.Conv layers of zuds_tpu/models/braai.py:27-49
// (BraaiD6, scored by rb_scores at :78-81): a 3x3 VALID correlation of an
// NHWC f32 batch with an HWIO kernel (no flip, as flax and F.conv2d
// compute it), plus the bias, then ReLU, and for layers 2 and 4 the 2x2/2
// max pool fused into the epilogue (floor: the odd last row and column
// are dropped, 59 -> 29 and 25 -> 12; a pooled layer computes only the
// 58x58 and 24x24 outputs its pool reads). NaN and +-inf reach exactly the
// outputs the plain version gives them (ReLU and the pool carry NaN).
//
// Layer 1 (Cin = 3, K = 27) is bound by bytes and stays a direct
// correlation on fp32 FMAs (conv3x3_kernel). Layers 2-4 are implicit GEMMs
// on the tensor cores (conv3x3_mma_kernel), M = convolution outputs, N =
// Cout, K = 9 Cin tap-major (288, 288, 576), in H19's 3xTF32 (below):
// the input staged once a block and split hi/lo once per staged element,
// the weights split once a call by a first launch (split_fwd_weights_kernel)
// into fragment order and streamed in chunks of 32 input channels of one
// tap through a cp.async double buffer, the pool, routing and dropout
// formed in registers. A non-finite value goes whole into lo (hi = 0), so
// inf * w stays inf (split_nf), and the flush drops a non-finite
// compensation (flush_nf). ptxas (sm_90a): 127-128 registers a thread, no
// spill, at every instance; 90-110 KB of shared memory (fwd_smem: the
// staged rows split hi/lo and two weight chunks; 108,544, 92,160 and
// 112,640 B at layers 2-4): two blocks an SM. Layer 1's conv3x3_kernel:
// 42 registers, no spill.
//
// Bound: 137.8 MFLOP per triplet over the four layers (6.43, 62.0, 26.9
// and 42.5 M), against 1.7 MB of activations moved: at 256 triplets layer
// 1 0.040 ms by bytes, layers 2-4 0.096, 0.042 and 0.066 ms by operations
// on 3xTF32 (three TF32 products a product at 495 TFLOP/s), 0.244 ms in
// all (0.54 ms on fp32 FMAs at 67 TFLOP/s). On an H100 the four layers
// take 0.90 ms (chip_smoke.py), 27% of that bound.
//
// H13t (the TRAIN flag of the same kernel) replaces the layers' forward
// under train_step (braai.py:90-105, BraaiD6 at train=True). It computes
// H13's values and, for the pooled layers, also writes per pooled output
// the routing byte: the index 0-3 (row-major in the 2x2 window) of the
// FIRST maximum, as XLA's select_and_scatter with `ge` and max_pool2d
// both route the gradient, or 255 where that maximum is <= 0, where ReLU
// gives every position of the window a zero gradient. Then it applies the
// dropout that follows the pool, flax's select(mask, v / keep, 0) (a
// division, rounded once). Serving keeps H13 unchanged. Backward needs
// only the byte and the mask of a pooled layer (29x29x32 and 12x12x64
// bytes a triplet, against 111 KB and 40 KB of pre-pool f32), and the
// layer's own output for an unpooled one (its ReLU mask).
//
// H19 replaces the input gradient XLA's autodiff forms for layers 2-4
// (the conv's VJP in train_step): a full 3x3 correlation of the gradient
// gz at the convolution's output with the spatially flipped kernel,
//   gx[iy, ix, ci] = sum_{ky, kx, co} gz[iy - ky, ix - kx, co] w[ky, kx, ci, co].
// gz comes from what H13t saved: for a pooled layer gz = (route ==
// position in the window and mask) ? gy / keep : 0 (0 in the odd last row
// and column), for an unpooled one gz = y > 0 ? gy : 0 -- selects and one
// division (grad_z4), so gz is bit-equal to XLA's and the plain version's.
//
// H20 replaces the weight and bias gradient of all four layers:
//   gw[ky, kx, ci, co] = sum_{n, cy, cx} x[n, cy + ky, cx + kx, ci] gz[n, cy, cx, co]
//   gb[co] = sum_{n, cy, cx} gz[n, cy, cx, co].
//
// H13 (layers 2-4), H19 and H20 are implicit GEMMs on the tensor cores,
// mma.sync m16n8k8 with the 3xTF32 split of H3 (apply.cu): v_hi =
// tf32(v), v_lo = tf32(v - v_hi) by cvt.rna, a*b ~ a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, each product exact, so the sum keeps fp32's accuracy (the
// dropped a_lo*b_lo is below 2^-22 of |a*b|); one TF32 pass, bf16 or fp16
// are not used. A chain of a few k-steps (the lo passes first in each)
// runs on the tensor cores, then is added into a second f32 accumulator by
// Kahan's compensated sum, whose compensation rides in the next chain's C
// (the flush: H19 once a tap, H13 and H20 every 4 k-steps). With 72 plain
// rounded adds an output instead (9 taps x 64 channels / 8), H19's layers
// 3-4 came out further from float64 than cuDNN (TF32 off) on an H100, at
// their largest error; a fourth pass (lo*lo) changed nothing. H20's bias
// sums and second pass are compensated.
//
// H19, M = input pixels, N = Cin, K = 9 Cout (tap-major). A block is 256
// consecutive pixels of one image (128 at Cin = 64: the 8 warps are 32
// pixels x 32 input channels each). gz is formed ONCE per staged element
// into shared memory with a zero halo: the positions of the block's
// pixels padded by two rows and two columns ("span", (W + 2) per row), so
// a tap is a constant offset into it and the edges cost no branch. K runs
// in chunks of 16 output channels: a chunk stages its 16 channels of gz
// and copies the chunk's 3 x 3 x Cin x 16 weights (split hi/lo once a call
// by a small first launch, in fragment order: one 128-bit load per lane
// and n-tile; cp.async, while gz is formed), then runs its 9 taps x 2
// k-steps. A fragments come by ldmatrix.x4 from the span (rows padded to
// 20 floats: no bank conflict). Shared memory 91-105 KB and 128 registers
// a thread: two blocks per SM.
//
// H20, M = 9 Cin rows (tap, ci), N = Cout, K = positions: a split-K GEMM.
// A block takes a fixed chunk of images (1, 1, 2, 4 at layers 1-4) and 288
// rows x 32 columns of the result (9 warps of 32 x 32; the 27 rows of
// layer 1 padded to 32, its 9 warps splitting K instead and reduced in
// warp order). It walks bands of conv rows: the band's x rows (with the
// two rows below) and gz (formed once, fragment order) are staged split
// hi/lo; an A fragment's address is a position's offset from a table (no
// division per element) plus a row's tap offset. The bias rides along in
// the staging loop (each thread one fixed quad of channels, in order),
// reduced in thread order. A second pass adds the chunks' partials in
// chunk order: no float atomics, two calls give the same bits.
//
// Bound: the routed FLOP (each element of the output gradient reaches one
// position, a pooled layer's through its routing byte, which takes 9 Cin
// products and sums), 53.0 MFLOP a triplet for H19 and 59.4 for H20, three
// times over on 3xTF32 at the card's TF32 peak; the bytes moved (x or gx,
// gy, the saved bytes) bound the pooled layers above that. The dense GEMMs
// compute every position of the routed region (a pooled layer's gz is 3/4
// zeros): 153 and 138 MFLOP a triplet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCT = 16;                    // channels per block (H13)
constexpr uint8_t kNoRoute = 255;

__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.f || isnan(v)) ? v : 0.f;
}

// H13 and H13t at layer 1 (Cin = 3, unpooled): a direct correlation on
// fp32 FMAs, bound by bytes. One thread per output pixel and kCT output
// channels in registers; a block is 256 pixels of one image and one tile
// of kCT channels, whose 3 x 3 x CIN x kCT weights sit in shared memory
// and are read as float4 broadcasts.
template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const float* __restrict__ in, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int tiles) {
  __shared__ __align__(16) float s_w[9 * CIN * kCT];
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int co0 = blockIdx.y * kCT;
  for (int i = threadIdx.x; i < 9 * CIN * kCT; i += kThreads) {
    const int kc = i / kCT, j = i - kc * kCT;
    s_w[i] = w[kc * COUT + co0 + j];
  }
  __syncthreads();

  const int Ho = H - 2, Wo = W - 2;
  const int p = tile * kThreads + threadIdx.x;
  if (p >= Ho * Wo) return;
  const int oy = p / Wo, ox = p - oy * Wo;
  const float* img = in + (long long)n * H * W * CIN;

  float acc[kCT];
#pragma unroll
  for (int j = 0; j < kCT; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3, kx = k - ky * 3;
    const float* ip = img + ((oy + ky) * W + ox + kx) * CIN;
    const float* wk = s_w + k * CIN * kCT;
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) {
      const float xv = ip[ci];
      const float4* w4 = reinterpret_cast<const float4*>(wk + ci * kCT);
#pragma unroll
      for (int j4 = 0; j4 < kCT / 4; ++j4) {
        const float4 wv = w4[j4];
        acc[4 * j4 + 0] = fmaf(xv, wv.x, acc[4 * j4 + 0]);
        acc[4 * j4 + 1] = fmaf(xv, wv.y, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(xv, wv.z, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(xv, wv.w, acc[4 * j4 + 3]);
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + ((long long)n * Ho * Wo + p) *
                                                  COUT + co0);
#pragma unroll
  for (int j4 = 0; j4 < kCT / 4; ++j4)
    o[j4] = make_float4(relu_nan(acc[4 * j4] + bias[co0 + 4 * j4]),
                        relu_nan(acc[4 * j4 + 1] + bias[co0 + 4 * j4 + 1]),
                        relu_nan(acc[4 * j4 + 2] + bias[co0 + 4 * j4 + 2]),
                        relu_nan(acc[4 * j4 + 3] + bias[co0 + 4 * j4 + 3]));
}

// The gradient at the convolution's output, four channels co..co+3 at
// (n, cy, cx), from what H13t saved (see the note at the top). A pooled
// layer reads its output gradient gy, routing bytes and dropout mask at
// the pooled pixel; an unpooled one gy and its output y at the pixel. The
// caller keeps (cy, cx) inside the rows and columns with a gradient.
template <int COUT, bool POOL>
__device__ __forceinline__ float4 grad_z4(const float* __restrict__ gy,
                                          const uint8_t* __restrict__ route,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ y,
                                          float keep, int n, int cy, int cx,
                                          int co, int Ho, int Wo) {
  if constexpr (POOL) {
    const long long off =
        (((long long)n * Ho + (cy >> 1)) * Wo + (cx >> 1)) * COUT + co;
    const uint8_t at = (uint8_t)(((cy & 1) << 1) | (cx & 1));
    const uchar4 r = *reinterpret_cast<const uchar4*>(route + off);
    const uchar4 m = mask != nullptr
                         ? *reinterpret_cast<const uchar4*>(mask + off)
                         : make_uchar4(1, 1, 1, 1);
    const float4 g = *reinterpret_cast<const float4*>(gy + off);
    return make_float4(r.x == at && m.x ? __fdiv_rn(g.x, keep) : 0.f,
                       r.y == at && m.y ? __fdiv_rn(g.y, keep) : 0.f,
                       r.z == at && m.z ? __fdiv_rn(g.z, keep) : 0.f,
                       r.w == at && m.w ? __fdiv_rn(g.w, keep) : 0.f);
  } else {
    const long long off = (((long long)n * Ho + cy) * Wo + cx) * COUT + co;
    const float4 v = *reinterpret_cast<const float4*>(y + off);
    const float4 g = *reinterpret_cast<const float4*>(gy + off);
    return make_float4(v.x > 0.f ? g.x : 0.f, v.y > 0.f ? g.y : 0.f,
                       v.z > 0.f ? g.z : 0.f, v.w > 0.f ? g.w : 0.f);
  }
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  hi = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
  lo = make_float4(tf32(v.x - hi.x), tf32(v.y - hi.y), tf32(v.z - hi.z),
                   tf32(v.w - hi.w));
}

// A fragment (16 x 8, rows 16 B-aligned in shared memory): lane l gives the
// address of row l % 16, columns 4 (l / 16) .. +3; ldmatrix's four 8 x 8
// b16 matrices are a0..a3 of mma_tf32.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One k-step of 3xTF32 over MT x NT tiles: acc += lo*hi + hi*lo + hi*hi,
// pass-major (the three MMAs on one accumulator are MT NT instructions
// apart). b: (b0_hi, b1_hi, b0_lo, b1_lo) per n-tile.
template <int MT, int NT>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4],
                                     const uint32_t (&ah)[MT][4],
                                     const uint32_t (&al)[MT][4],
                                     const float4 (&b)[NT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[m][j], al[m], b[j].x, b[j].y);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[m][j], ah[m], b[j].z, b[j].w);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[m][j], ah[m], b[j].x, b[j].y);
}

// The flush: sum += acc, compensated. acc keeps what the rounded add lost
// (Kahan's compensation), so the next MMA chain starts from it as its C.
template <int MT, int NT>
__device__ __forceinline__ void flush(float (&sum)[MT][NT][4],
                                      float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = sum[m][j][e] + acc[m][j][e];
        acc[m][j][e] -= t - sum[m][j][e];
        sum[m][j][e] = t;
      }
}

// s += v by Kahan's compensated summation (c the running compensation).
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c, t = s + y;
  c = (t - s) - y;
  s = t;
}

// 16 bytes global -> shared, asynchronous (cp.async.wait_all completes them)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- H13 on the tensor cores (layers 2-4) ----------------------------------
// The 3xTF32 split of one value, v = hi + lo. A non-finite v (or one whose
// TF32 rounding overflows) goes whole into lo with hi = 0: the products
// then reduce to lo * b_hi, so +-inf times a weight stays +-inf (a split
// lo = 0 would add inf * b_lo, NaN where b_lo is 0 or of the other sign)
// and NaN stays NaN.
__device__ __forceinline__ void split_nf(float v, float& hi, float& lo) {
  const float h = tf32(v);
  if (isfinite(h)) {
    hi = h;
    lo = tf32(v - h);
  } else {
    hi = 0.f;
    lo = v;
  }
}

// The flush of flush(), with the compensation dropped where the sum is not
// finite (inf - inf would carry a NaN into the next chain).
template <int MT, int NT>
__device__ __forceinline__ void flush_nf(float (&sum)[MT][NT][4],
                                         float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = sum[m][j][e] + acc[m][j][e];
        const float c = acc[m][j][e] - (t - sum[m][j][e]);
        acc[m][j][e] = isfinite(t) ? c : 0.f;
        sum[m][j][e] = t;
      }
}

constexpr int kFwKC = 32;       // input channels (K) of a weight chunk
constexpr int kFwBR = 2;        // pooled rows a block
constexpr int kFwBM = 128;      // convolution outputs a block, unpooled

template <int CIN, int COUT>
struct FwdTile {
  static constexpr int kCG = COUT / 32;             // warps along Cout
  static constexpr int kNTT = COUT / 8;             // n-tiles of Cout
  static constexpr int kChunks = 9 * CIN / kFwKC;   // 9, 9, 18
  static constexpr int kChunkF4 = kFwKC / 8 * kNTT * 32;   // float4 a chunk
  static constexpr int kMaxPW = 32 / kCG;           // pooled columns a block
};

// A block's share of one image and the staged input. Pooled: kFwBR pooled
// rows by a segment of at most kMaxPW pooled columns (8 pooled outputs a
// warp group), the input rows and columns they read staged with the even
// columns before the odd (so a tap's eight A rows, at every other column,
// are consecutive slots). Unpooled: kFwBM consecutive outputs in row-major
// order and the whole input rows they read.
struct FwdGeom {
  int H, W, Ho, Wo;
  int bands;        // blocks an image
  int segs, pw;     // pooled: column segments a band, pooled columns each
  int groups;       // warp groups along M (8 pooled or 32 plain outputs)
  int rows, ws, wh; // staged rows, slots a row, slots of the even columns
};

template <int CIN, int COUT, bool POOL>
__host__ __device__ FwdGeom fwd_geom(int H, int W) {
  using T = FwdTile<CIN, COUT>;
  FwdGeom g;
  g.H = H;
  g.W = W;
  if (POOL) {
    g.Ho = (H - 2) / 2;
    g.Wo = (W - 2) / 2;
    g.segs = (g.Wo + T::kMaxPW - 1) / T::kMaxPW;
    g.pw = g.segs > 0 ? (g.Wo + g.segs - 1) / g.segs : 0;
    g.groups = (kFwBR * g.pw + 7) / 8;
    g.bands = (g.Ho + kFwBR - 1) / kFwBR * g.segs;
    g.rows = 2 * kFwBR + 2;
    g.wh = g.pw + 1;
    g.ws = 2 * g.wh;
  } else {
    g.Ho = H - 2;
    g.Wo = W - 2;
    g.segs = 1;
    g.pw = 0;
    g.groups = kFwBM / 32;
    g.bands = (g.Ho * g.Wo + kFwBM - 1) / kFwBM;
    g.rows = (kFwBM - 1) / g.Wo + 4 < H ? (kFwBM - 1) / g.Wo + 4 : H;
    g.wh = 0;
    g.ws = W;
  }
  return g;
}

template <int CIN, int COUT>
size_t fwd_smem(const FwdGeom& g) {
  return (2 * (size_t)g.rows * g.ws * CIN +
          2 * (size_t)FwdTile<CIN, COUT>::kChunkF4 * 4) *
         sizeof(float);
}

// H13's weights split once a call, in the blocks' fragment order: chunk c
// (tap c / (CIN / 32), input channels 32 (c % (CIN / 32)) ..), entry (ks
// kNTT + nt) 32 + lane holds w[tap][c0 + ks 8 + t (+4)][nt 8 + g], hi and
// lo: (b0_hi, b1_hi, b0_lo, b1_lo).
template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    split_fwd_weights_kernel(const float* __restrict__ w,
                             float4* __restrict__ wf) {
  using T = FwdTile<CIN, COUT>;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= T::kChunks * T::kChunkF4) return;
  const int c = e / T::kChunkF4, r0 = e - c * T::kChunkF4;
  const int ln = r0 & 31, r = r0 >> 5;
  const int nt = r % T::kNTT, ks = r / T::kNTT;
  const int tap = c / (CIN / kFwKC);
  const int ci = (c % (CIN / kFwKC)) * kFwKC + ks * 8 + (ln & 3);
  const float* src = w + (tap * CIN + ci) * COUT + nt * 8 + (ln >> 2);
  float h0, l0, h1, l1;
  split_nf(src[0], h0, l0);
  split_nf(src[4 * COUT], h1, l1);
  wf[e] = make_float4(h0, h1, l0, l1);
}

// H13 and H13t at layers 2-4: M = the block's convolution outputs, N =
// Cout, K = 9 Cin (tap-major). Each warp holds 32 outputs x 32 channels
// (2 m-tiles x 4 n-tiles); at a pooled layer its m-tiles are 8 pooled
// outputs, rows g and g + 8 of m-tile dy the window positions (dy, 0) and
// (dy, 1), so the 2x2 max, the routing byte and the dropout are formed in
// registers. The input is staged once, split hi/lo, rows of CIN floats
// with the 16-byte chunks XOR-swizzled by the slot (ldmatrix reads eight
// slots of one chunk without a bank conflict); the split weights stream
// through a cp.async double buffer, 32 input channels (4 k-steps) a chunk:
// chunk c + 1 is copied while chunk c runs. Each chunk's chain of 4
// k-steps is flushed into the sum by flush_nf.
template <int CIN, int COUT, bool POOL, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_mma_kernel(const float* __restrict__ in,
                       const float4* __restrict__ wf,
                       const float* __restrict__ bias, float* __restrict__ out,
                       uint8_t* __restrict__ route,
                       const uint8_t* __restrict__ mask, float keep,
                       FwdGeom G) {
  using T = FwdTile<CIN, COUT>;
  extern __shared__ __align__(16) float smem[];
  const int nx = G.rows * G.ws * CIN;
  float* s_hi = smem;
  float* s_lo = s_hi + nx;
  float4* s_w = reinterpret_cast<float4*>(s_lo + nx);
  const int nthreads = blockDim.x;

  const auto load_chunk = [&](int c) {
    const float4* src = wf + c * T::kChunkF4;
    float4* dst = s_w + (c & 1) * T::kChunkF4;
    for (int i = threadIdx.x; i < T::kChunkF4; i += nthreads)
      cp_async16(dst + i, src + i);
  };
  load_chunk(0);

  const int n = blockIdx.x / G.bands, band = blockIdx.x - n * G.bands;
  // the block's outputs and the input it stages: rows y0.., columns x0..
  int y0, x0, ncol, nvalid, p0 = 0;
  if (POOL) {
    const int rb = band / G.segs, seg = band - rb * G.segs;
    const int py0 = rb * kFwBR, px0 = seg * G.pw;
    ncol = min(G.pw, G.Wo - px0);
    nvalid = min(kFwBR, G.Ho - py0) * ncol;
    y0 = 2 * py0;
    x0 = 2 * px0;
  } else {
    p0 = band * kFwBM;
    nvalid = min(kFwBM, G.Ho * G.Wo - p0);
    ncol = G.Wo;
    y0 = p0 / G.Wo;
    x0 = 0;
  }
  const int srows = min(G.rows, G.H - y0);
  const int scols = POOL ? min(G.ws, G.W - x0) : G.W;
  {
    const float* src = in + (((long long)n * G.H + y0) * G.W + x0) * CIN;
    const int total = srows * scols * (CIN / 4);
    for (int e = threadIdx.x; e < total; e += nthreads) {
      const int c4 = e % (CIN / 4), pix = e / (CIN / 4);
      const int row = pix / scols, col = pix - row * scols;
      const float4 v = *reinterpret_cast<const float4*>(
          src + ((long long)row * G.W + col) * CIN + 4 * c4);
      const int slot = POOL ? (col & 1) * G.wh + (col >> 1) : col;
      const int L = row * G.ws + slot;
      const int off = L * CIN + ((c4 ^ (L & 7)) << 2);
      float4 hi, lo;
      split_nf(v.x, hi.x, lo.x);
      split_nf(v.y, hi.y, lo.y);
      split_nf(v.z, hi.z, lo.z);
      split_nf(v.w, hi.w, lo.w);
      *reinterpret_cast<float4*>(s_hi + off) = hi;
      *reinterpret_cast<float4*>(s_lo + off) = lo;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp % T::kCG, grp = warp / T::kCG;
  // the A row this lane addresses for ldmatrix (row lane % 16, channels
  // +4 (lane / 16)): its slot at tap (0, 0) for each m-tile, clamped to a
  // valid output (rows past the block's outputs are computed and dropped)
  const int ar = lane & 15, dx = ar >> 3;
  int abase[2];
  if (POOL) {
    const int s = min(grp * 8 + (ar & 7), nvalid - 1);
    const int ly = s / ncol, lx = s - ly * ncol;
#pragma unroll
    for (int m = 0; m < 2; ++m) abase[m] = (2 * ly + m) * G.ws + lx;
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int p = min(p0 + grp * 32 + m * 16 + ar, p0 + nvalid - 1);
      const int cy = p / G.Wo;
      abase[m] = (cy - y0) * G.ws + p - cy * G.Wo;
    }
  }

  float sum[2][4][4], acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[m][j][e] = acc[m][j][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < T::kChunks; ++c) {
    cp_async_wait_all();
    __syncthreads();     // chunk c and the staged input are visible; chunk
                         // c - 1's buffer is free
    if (c + 1 < T::kChunks) load_chunk(c + 1);
    const int tap = c / (CIN / kFwKC);
    const int ci0 = (c - tap * (CIN / kFwKC)) * kFwKC;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int toff =
        POOL ? ky * G.ws + ((dx + kx) & 1) * G.wh + ((dx + kx) >> 1)
             : ky * G.ws + kx;
    int L[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) L[m] = abase[m] + toff;
    const float4* wb = s_w + (c & 1) * T::kChunkF4;
#pragma unroll
    for (int ks = 0; ks < kFwKC / 8; ++ks) {
      const int q = (ci0 >> 2) + ks * 2 + (lane >> 4);   // 16-byte chunk
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int off = L[m] * CIN + ((q ^ (L[m] & 7)) << 2);
        ldsm_x4(ah[m], s_hi + off);
        ldsm_x4(al[m], s_lo + off);
      }
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = wb[(ks * T::kNTT + cg * 4 + j) * 32 + lane];
      mma3<2, 4>(acc, ah, al, b);
    }
    flush_nf<2, 4>(sum, acc);
  }
  flush_nf<2, 4>(sum, acc);     // the last compensation

  const int co0 = cg * 32 + 2 * t;
  if (POOL) {
    const int s = grp * 8 + g;
    if (s >= nvalid) return;
    const int ly = s / ncol, lx = s - ly * ncol;
    const int py = y0 / 2 + ly, px = x0 / 2 + lx;
    const long long off = (((long long)n * G.Ho + py) * G.Wo + px) * COUT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + j * 8;
      uchar2 kb = make_uchar2(1, 1);
      if (TRAIN && mask != nullptr)
        kb = *reinterpret_cast<const uchar2*>(mask + off + co);
      float res[2];
      uint8_t rt[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = bias[co + e];
        // positions 0-3 of the window, row-major; nan_max's update rule,
        // tracking where the first maximum sits
        const float q[4] = {sum[0][j][e], sum[0][j][2 + e], sum[1][j][e],
                            sum[1][j][2 + e]};
        float v = relu_nan(q[0] + b);
        int arg = 0;
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const float u = relu_nan(q[k] + b);
          if (isnan(u) || u > v) {
            v = u;
            arg = k;
          }
        }
        if constexpr (TRAIN) {
          rt[e] = v > 0.f ? (uint8_t)arg : kNoRoute;
          v = (e == 0 ? kb.x : kb.y) ? __fdiv_rn(v, keep) : 0.f;
        }
        res[e] = v;
      }
      *reinterpret_cast<float2*>(out + off + co) = make_float2(res[0], res[1]);
      if constexpr (TRAIN)
        *reinterpret_cast<uchar2*>(route + off + co) =
            make_uchar2(rt[0], rt[1]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = grp * 32 + m * 16 + g + 8 * h;
        if (p >= nvalid) continue;
        const long long off =
            ((long long)n * G.Ho * G.Wo + p0 + p) * COUT + co0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = co0 + j * 8;
          *reinterpret_cast<float2*>(out + off + j * 8) =
              make_float2(relu_nan(sum[m][j][2 * h] + bias[co]),
                          relu_nan(sum[m][j][2 * h + 1] + bias[co + 1]));
        }
      }
  }
}

// ---- H19 -------------------------------------------------------------------
constexpr int kDgThreads = 256;
constexpr int kCC = 16;        // output channels of gz (K) per chunk
constexpr int kGS = kCC + 4;   // floats per staged position

template <int CIN>
struct DgradTile {
  static constexpr int kGroups = CIN / 32;                 // warps along Cin
  static constexpr int kPixels = kDgThreads / kGroups;     // 32 per warp
  static constexpr int kNT = CIN / 8;                      // n-tiles
  static constexpr int kWFloats = 9 * 2 * kNT * 32 * 4;    // a chunk's weights
};

// Positions staged for a block of ``pixels`` consecutive pixels of rows of
// W: their padded positions and two rows and two columns before them.
__host__ __device__ __forceinline__ int dgrad_span(int pixels, int W) {
  return pixels + 2 * ((pixels - 1) / W + 1) + 2 * (W + 2) + 2;
}

template <int CIN>
size_t dgrad_smem(int W) {
  return (DgradTile<CIN>::kWFloats +
          2 * (size_t)dgrad_span(DgradTile<CIN>::kPixels, W) * kGS) *
         sizeof(float);
}

// H19's weights split once a call, in the blocks' fragment order: chunk c,
// entry ((tap 2 + ks) kNT + nt) 32 + lane holds w[tap][nt 8 + g][c 16 +
// ks 8 + t (+4)], hi and lo: (b0_hi, b1_hi, b0_lo, b1_lo).
template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    split_weights_kernel(const float* __restrict__ w,
                         float4* __restrict__ wf) {
  constexpr int kNT = CIN / 8, kPer = DgradTile<CIN>::kWFloats / 4;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= (COUT / kCC) * kPer) return;
  const int c = e / kPer, r0 = e - c * kPer;
  const int ln = r0 & 31, r = r0 >> 5;
  const int nt = r % kNT, tk = r / kNT;
  const int ci = nt * 8 + (ln >> 2);
  const int co = c * kCC + (tk & 1) * 8 + (ln & 3);
  const float* src = w + ((tk >> 1) * CIN + ci) * COUT + co;
  const float b0 = src[0], b1 = src[4];
  const float h0 = tf32(b0), h1 = tf32(b1);
  wf[e] = make_float4(h0, h1, tf32(b0 - h0), tf32(b1 - h1));
}

template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kDgThreads, 2)
    dgrad_kernel(const float* __restrict__ gy,
                 const uint8_t* __restrict__ route,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ y, float keep,
                 const float4* __restrict__ wf, float* __restrict__ gx, int H,
                 int W, int tiles) {
  using T = DgradTile<CIN>;
  extern __shared__ __align__(16) float smem[];
  const int WP = W + 2, HW = H * W;
  float* s_w = smem;                                  // fragment order
  float* s_hi = s_w + T::kWFloats;                    // span x kGS
  float* s_lo = s_hi + dgrad_span(T::kPixels, W) * kGS;

  const int n = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - n * tiles) * T::kPixels;
  const int plast = min(p0 + T::kPixels, HW) - 1;
  // padded position of pixel p: (p / W + 2) (W + 2) + p % W + 2
  const int q_lo = (p0 / W) * WP + p0 % W;
  const int count = (plast / W + 2) * WP + plast % W + 2 - q_lo + 1;
  const int Hc = H - 2, Wc = W - 2;
  const int Ho = POOL ? Hc / 2 : Hc, Wo = POOL ? Wc / 2 : Wc;
  const int He = POOL ? 2 * Ho : Hc, We = POOL ? 2 * Wo : Wc;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp % T::kGroups, pw = warp / T::kGroups;
  int abase[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = min(p0 + pw * 32 + m * 16 + (lane & 15), HW - 1);
    abase[m] = ((p / W + 2) * WP + p % W + 2 - q_lo) * kGS + (lane >> 4) * 4;
  }
  float sum[2][4][4], acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[m][j][e] = acc[m][j][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < COUT / kCC; ++c) {
    __syncthreads();     // the previous chunk's fragments are read
    // the chunk's split weights, copied while gz is formed
    for (int e = threadIdx.x; e < T::kWFloats / 4; e += kDgThreads)
      cp_async16(s_w + 4 * e, wf + c * (T::kWFloats / 4) + e);
    // gz on the span, zero outside the rows and columns with a gradient
    for (int e = threadIdx.x; e < count * (kCC / 4); e += kDgThreads) {
      const int pos = e / (kCC / 4), qd = e % (kCC / 4);
      const int q = q_lo + pos, r = q / WP;
      const int cy = r - 2, cx = q - r * WP - 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cy >= 0 && cy < He && cx >= 0 && cx < We)
        v = grad_z4<COUT, POOL>(gy, route, mask, y, keep, n, cy, cx,
                                c * kCC + qd * 4, Ho, Wo);
      float4 hi, lo;
      split4(v, hi, lo);
      *reinterpret_cast<float4*>(s_hi + pos * kGS + qd * 4) = hi;
      *reinterpret_cast<float4*>(s_lo + pos * kGS + qd * 4) = lo;
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * WP + tap % 3) * kGS;
#pragma unroll
      for (int ks = 0; ks < kCC / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          ldsm_x4(ah[m], s_hi + abase[m] - toff + ks * 8);
          ldsm_x4(al[m], s_lo + abase[m] - toff + ks * 8);
        }
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = reinterpret_cast<const float4*>(
              s_w)[((tap * 2 + ks) * T::kNT + cg * 4 + j) * 32 + lane];
        mma3<2, 4>(acc, ah, al, b);
      }
      flush<2, 4>(sum, acc);      // once a tap: two k-steps a chain
    }
  }

  flush<2, 4>(sum, acc);        // the last compensation
  float* out = gx + (long long)n * HW * CIN;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = p0 + pw * 32 + m * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = cg * 32 + j * 8 + 2 * t;
      if (p < HW)
        *reinterpret_cast<float2*>(out + (long long)p * CIN + ci) =
            make_float2(sum[m][j][0], sum[m][j][1]);
      if (p + 8 < HW)
        *reinterpret_cast<float2*>(out + (long long)(p + 8) * CIN + ci) =
            make_float2(sum[m][j][2], sum[m][j][3]);
    }
  }
}

// ---- H20 -------------------------------------------------------------------
constexpr int kWgWarps = 9;
constexpr int kWgThreads = kWgWarps * 32;
constexpr int kFlush = 4;      // k-steps a chain

template <int CIN, int COUT, bool POOL>
struct WgradTile {
  static constexpr int kRows = 9 * CIN;
  static constexpr int kRowTiles = (kRows + 31) / 32;            // 1, 9, 9, 18
  static constexpr int kRowBlocks = (kRowTiles + kWgWarps - 1) / kWgWarps;
  static constexpr int kColBlocks = COUT / 32;
  // layer 1's one row tile: its 9 warps split K
  static constexpr int kSplit = kRowTiles < kWgWarps ? kWgWarps : 1;
  // images a block: 256 blocks at a batch of 256 on every layer
  static constexpr int kImages = kRowBlocks * kColBlocks;
  // conv rows a band; floats a staged pixel of x (bank padding)
  static constexpr int kBand = CIN == 3 ? 4 : CIN == 32 ? (POOL ? 2 : 4) : 3;
  static constexpr int kXS = CIN == 3 ? 4 : CIN + 8;
  static constexpr int kCount = kRows * COUT + COUT;
};

template <int CIN, int COUT, bool POOL>
size_t wgrad_smem(int W, int We) {
  using T = WgradTile<CIN, COUT, POOL>;
  const size_t kst = (T::kBand * We + 7) / 8;
  const size_t stage = 2 * (size_t)(T::kBand + 2) * W * T::kXS + kst * 512 +
                       kst * 8;
  const size_t reduce = T::kSplit > 1 ? (size_t)kWgWarps * 32 * 32 : 0;
  const size_t bias = (size_t)kWgThreads * 4;
  size_t floats = stage > reduce ? stage : reduce;
  floats = floats > bias ? floats : bias;
  return floats * sizeof(float);
}

// Pass one of H20: block (chunk of images, row block, column block) sums
// its images' terms into partial[chunk][row * COUT + col] and, in row block
// 0, the bias into partial[chunk][9 CIN COUT + col].
// Two blocks an SM hold it to 96 registers (ptxas spills ~48 bytes); at
// 112 only one block an SM fits, and the layers took 1.4x as long on an
// H100.
template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kWgThreads, 2)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                 const uint8_t* __restrict__ route,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ y, float keep,
                 float* __restrict__ partial, int N, int H, int W) {
  using T = WgradTile<CIN, COUT, POOL>;
  extern __shared__ __align__(16) float smem[];
  const int Hc = H - 2, Wc = W - 2;
  const int Ho = POOL ? Hc / 2 : Hc, Wo = POOL ? Wc / 2 : Wc;
  const int He = POOL ? 2 * Ho : Hc, We = POOL ? 2 * Wo : Wc;
  const int kst = (T::kBand * We + 7) / 8;          // k-steps of a full band
  const int xfl = (T::kBand + 2) * W * T::kXS;
  float* s_xhi = smem;
  float* s_xlo = s_xhi + xfl;
  float* s_g = s_xlo + xfl;           // k-step, n-tile, lane: (b0, b1) hi, lo
  int* s_pix = reinterpret_cast<int*>(s_g + kst * 512);

  const int chunk = blockIdx.x;
  const int rb = blockIdx.y / T::kColBlocks, cb = blockIdx.y % T::kColBlocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = T::kSplit > 1 ? 0 : rb * kWgWarps + warp;
  const int k0 = T::kSplit > 1 ? warp : 0;
  const bool bias = rb == 0;
  // offset of row (tap, ci) in the staged x: the tap's pixel shift and ci
  // (at Cin >= 32 a warp's 32 rows lie in one tap: rows g + 8 i follow row g)
  const auto row_off = [&](int r) {
    const int tap = r / CIN;
    return r < T::kRows ? ((tap / 3) * W + tap % 3) * T::kXS + r - tap * CIN
                        : 0;
  };
  int roff[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      roff[m][h] = CIN % 32 == 0 ? row_off(rt * 32 + g) + m * 16 + 8 * h
                                 : row_off(rt * 32 + m * 16 + g + 8 * h);
  // offset of position k of a band (its conv row k / We) in the staged x
  for (int k = threadIdx.x; k < kst * 8; k += kWgThreads)
    s_pix[k] = k < T::kBand * We ? ((k / We) * W + k % We) * T::kXS : 0;

  float sum[2][4][4], acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[m][j][e] = acc[m][j][e] = 0.f;
  float bsum[4] = {0.f, 0.f, 0.f, 0.f}, bcomp[4] = {0.f, 0.f, 0.f, 0.f};

  const int n1 = min((chunk + 1) * T::kImages, N);
#pragma unroll 1
  for (int n = chunk * T::kImages; n < n1; ++n) {
    const float* img = x + (long long)n * H * W * CIN;
#pragma unroll 1
    for (int cy0 = 0; cy0 < He; cy0 += T::kBand) {
      const int nb = min(T::kBand, He - cy0);
      const int npos = nb * We, nks = (npos + 7) / 8;
      const int xrows = min(T::kBand + 2, H - cy0);
      __syncthreads();     // the previous band's fragments are read
      // x rows cy0 .. cy0 + kBand + 1 (zero past the image)
      if constexpr (CIN % 4 == 0) {
        for (int e = threadIdx.x; e < (T::kBand + 2) * W * (CIN / 4);
             e += kWgThreads) {
          const int pix = e / (CIN / 4), qd = e % (CIN / 4);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (pix < xrows * W)
            v = *reinterpret_cast<const float4*>(
                img + ((long long)cy0 * W + pix) * CIN + qd * 4);
          float4 hi, lo;
          split4(v, hi, lo);
          *reinterpret_cast<float4*>(s_xhi + pix * T::kXS + qd * 4) = hi;
          *reinterpret_cast<float4*>(s_xlo + pix * T::kXS + qd * 4) = lo;
        }
      } else {
        for (int e = threadIdx.x; e < (T::kBand + 2) * W * CIN;
             e += kWgThreads) {
          const int pix = e / CIN, ci = e - pix * CIN;
          const float v =
              pix < xrows * W ? img[((long long)cy0 * W) * CIN + e] : 0.f;
          const float hi = tf32(v);
          s_xhi[pix * T::kXS + ci] = hi;
          s_xlo[pix * T::kXS + ci] = tf32(v - hi);
        }
      }
      // gz of the band's positions, in fragment order: position k of k-step
      // ks = k / 8 is B's row t = k % 4 (b0 for k % 8 < 4, else b1)
      for (int e = threadIdx.x; e < nks * 64; e += kWgThreads) {
        const int pos = e >> 3, qd = e & 7;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (pos < npos) {
          const int r = pos / We;
          v = grad_z4<COUT, POOL>(gy, route, mask, y, keep, n, cy0 + r,
                                  pos - r * We, cb * 32 + qd * 4, Ho, Wo);
        }
        if (bias) {
          kahan_add(bsum[0], bcomp[0], v.x);
          kahan_add(bsum[1], bcomp[1], v.y);
          kahan_add(bsum[2], bcomp[2], v.z);
          kahan_add(bsum[3], bcomp[3], v.w);
        }
        float4 hi, lo;
        split4(v, hi, lo);
        const float hv[4] = {hi.x, hi.y, hi.z, hi.w};
        const float lv[4] = {lo.x, lo.y, lo.z, lo.w};
        const int ks = pos >> 3, tt = pos & 7, half = tt >> 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = qd * 4 + j;
          float* d = s_g + (((ks * 4 + (col >> 3)) * 32 + (col & 7) * 4 +
                             (tt & 3)) << 2);
          d[half] = hv[j];
          d[2 + half] = lv[j];
        }
      }
      __syncthreads();
      // chains of kFlush k-steps (the warp's own, at layer 1), one flush each
#pragma unroll 1
      for (int ks0 = k0; ks0 < nks; ks0 += kFlush * T::kSplit) {
#pragma unroll
        for (int u = 0; u < kFlush; ++u) {
          const int ks = ks0 + u * T::kSplit;
          if (ks >= nks) break;
          const int pa = s_pix[ks * 8 + t], pb = s_pix[ks * 8 + t + 4];
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int o[4] = {pa + roff[m][0], pa + roff[m][1],
                              pb + roff[m][0], pb + roff[m][1]};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[m][i] = __float_as_uint(s_xhi[o[i]]);
              al[m][i] = __float_as_uint(s_xlo[o[i]]);
            }
          }
          float4 b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = reinterpret_cast<const float4*>(
                s_g)[(ks * 4 + j) * 32 + lane];
          mma3<2, 4>(acc, ah, al, b);
        }
        flush<2, 4>(sum, acc);
      }
    }
  }
  flush<2, 4>(sum, acc);        // the last compensation

  float* part = partial + (long long)chunk * T::kCount;
  __syncthreads();       // the staging buffers become scratch
  if constexpr (T::kSplit > 1) {
    // each warp's sum over its k-steps, added in warp order
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m * 16 + g + 8 * (e >> 1), c = j * 8 + 2 * t + (e & 1);
          smem[(warp * 32 + r) * 32 + c] = sum[m][j][e];
        }
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * 32; i += kWgThreads) {
      float s = 0.f, c = 0.f;
      for (int v = 0; v < kWgWarps; ++v) kahan_add(s, c, smem[v * 1024 + i]);
      const int r = i >> 5, col = i & 31;
      if (r < T::kRows) part[r * COUT + cb * 32 + col] = s - c;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = rt * 32 + m * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb * 32 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(part + r * COUT + c) =
            make_float2(sum[m][j][0], sum[m][j][1]);
        *reinterpret_cast<float2*>(part + (r + 8) * COUT + c) =
            make_float2(sum[m][j][2], sum[m][j][3]);
      }
    }
  }
  if (bias) {
    // thread i summed channel quad i % 8: add the 36 threads of a quad in
    // thread order
#pragma unroll
    for (int e = 0; e < 4; ++e) smem[threadIdx.x * 4 + e] = bsum[e] - bcomp[e];
    __syncthreads();
    if (threadIdx.x < 32) {
      const int qd = threadIdx.x >> 2, e = threadIdx.x & 3;
      float s = 0.f, c = 0.f;
      for (int i = qd; i < kWgThreads; i += 8) kahan_add(s, c, smem[i * 4 + e]);
      part[T::kRows * COUT + cb * 32 + threadIdx.x] = s - c;
    }
  }
}

// Pass two of H20: out[i] = sum over the chunks of partial[c][i], in chunk
// order, compensated.
__global__ void __launch_bounds__(kThreads)
    wgrad_sum_kernel(const float* __restrict__ partial, int chunks, int count,
                     float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.f, comp = 0.f;
  for (int c = 0; c < chunks; ++c)
    kahan_add(s, comp, partial[(long long)c * count + i]);
  out[i] = s - comp;
}

template <int CIN, int COUT>
int launch(const float* in, const float* w, const float* bias, float* out,
           int N, int H, int W, cudaStream_t stream) {
  const int npix = (H - 2) * (W - 2);
  const int tiles = (npix + kThreads - 1) / kThreads;
  if (N > 0 && npix > 0) {
    const dim3 grid(N * tiles, COUT / kCT);
    conv3x3_kernel<CIN, COUT><<<grid, kThreads, 0, stream>>>(in, w, bias, out,
                                                             H, W, tiles);
  }
  return (int)cudaGetLastError();
}

// Set a kernel's dynamic shared memory (above 48 KB needs the attribute).
// An error (more than the card gives a block) comes back to the caller and
// is cleared, so that no later launcher's cudaGetLastError reports it.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// H13/H13t at layers 2-4: the weights split into wsplit (18 CIN COUT
// floats, 16-byte aligned) by a first launch, then the implicit GEMM. A
// shape whose staged input does not fit in shared memory is refused
// (the error returned, not left pending).
template <int CIN, int COUT, bool POOL, bool TRAIN>
int launch_mma(const float* in, const float* w, const float* bias,
               float* wsplit, float* out, uint8_t* route, const uint8_t* mask,
               float keep, int N, int H, int W, cudaStream_t stream) {
  using T = FwdTile<CIN, COUT>;
  const FwdGeom g = fwd_geom<CIN, COUT, POOL>(H, W);
  if (N > 0 && g.Ho > 0 && g.Wo > 0) {
    const size_t smem = fwd_smem<CIN, COUT>(g);
    cudaError_t err = allow_smem(conv3x3_mma_kernel<CIN, COUT, POOL, TRAIN>,
                                 smem);
    if (err != cudaSuccess) return (int)err;
    constexpr int kEntries = T::kChunks * T::kChunkF4;     // float4
    float4* wf = reinterpret_cast<float4*>(wsplit);
    split_fwd_weights_kernel<CIN, COUT>
        <<<(kEntries + kThreads - 1) / kThreads, kThreads, 0, stream>>>(w,
                                                                        wf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    conv3x3_mma_kernel<CIN, COUT, POOL, TRAIN>
        <<<N * g.bands, 32 * T::kCG * g.groups, smem, stream>>>(
            in, wf, bias, out, route, mask, keep, g);
  }
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, bool POOL>
int launch_dgrad(const float* gy, const uint8_t* route, const uint8_t* mask,
                 const float* y, float keep, const float* w, float* wsplit,
                 float* gx, int N, int H, int W, cudaStream_t stream) {
  if (N > 0 && H > 2 && W > 2) {
    const int tiles = (H * W + DgradTile<CIN>::kPixels - 1) /
                      DgradTile<CIN>::kPixels;
    const size_t smem = dgrad_smem<CIN>(W);
    cudaError_t err = allow_smem(dgrad_kernel<CIN, COUT, POOL>, smem);
    if (err != cudaSuccess) return (int)err;
    constexpr int kEntries = 18 * CIN * COUT / 4;      // float4
    float4* wf = reinterpret_cast<float4*>(wsplit);
    split_weights_kernel<CIN, COUT>
        <<<(kEntries + kThreads - 1) / kThreads, kThreads, 0, stream>>>(w,
                                                                        wf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dgrad_kernel<CIN, COUT, POOL><<<N * tiles, kDgThreads, smem, stream>>>(
        gy, route, mask, y, keep, wf, gx, H, W, tiles);
  }
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, bool POOL>
int launch_wgrad(const float* x, const float* gy, const uint8_t* route,
                 const uint8_t* mask, const float* y, float keep,
                 float* partial, float* out, int N, int H, int W,
                 cudaStream_t stream) {
  using T = WgradTile<CIN, COUT, POOL>;
  if (N > 0 && H > 2 && W > 2) {
    const int Wc = W - 2, We = POOL ? 2 * (Wc / 2) : Wc;
    const size_t smem = wgrad_smem<CIN, COUT, POOL>(W, We);
    cudaError_t err = allow_smem(wgrad_kernel<CIN, COUT, POOL>, smem);
    if (err != cudaSuccess) return (int)err;
    const int chunks = (N + T::kImages - 1) / T::kImages;
    const dim3 grid(chunks, T::kRowBlocks * T::kColBlocks);
    wgrad_kernel<CIN, COUT, POOL><<<grid, kWgThreads, smem, stream>>>(
        x, gy, route, mask, y, keep, partial, N, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wgrad_sum_kernel<<<(T::kCount + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(partial, chunks, T::kCount, out);
  } else if (N == 0) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, T::kCount * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,), out (N, Ho, Wo,
// Cout), all f32 and contiguous; the four layers of BraaiD6 only. wsplit:
// scratch of 18 Cin Cout floats, 16-byte aligned (layers 2-4: the weights
// split hi/lo; unused, may be null, at layer 1).
extern "C" int zuds_braai_conv3x3(const float* in, const float* w,
                                  const float* bias, float* wsplit,
                                  float* out, int N, int H, int W, int Cin,
                                  int Cout, int pool, cudaStream_t stream) {
  if (Cin == 3 && Cout == 32 && !pool)
    return launch<3, 32>(in, w, bias, out, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch_mma<32, 32, true, false>(in, w, bias, wsplit, out, nullptr,
                                           nullptr, 1.f, N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch_mma<32, 64, false, false>(in, w, bias, wsplit, out,
                                            nullptr, nullptr, 1.f, N, H, W,
                                            stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch_mma<64, 64, true, false>(in, w, bias, wsplit, out, nullptr,
                                           nullptr, 1.f, N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

// H13t: as zuds_braai_conv3x3, and for the pooled layers route (N, Ho, Wo,
// Cout) u8 and the dropout mask (u8 of the same shape, or null for none)
// applied as mask ? v / keep : 0.
extern "C" int zuds_braai_conv3x3_train(const float* in, const float* w,
                                        const float* bias, float* wsplit,
                                        float* out, uint8_t* route,
                                        const uint8_t* mask, float keep,
                                        int N, int H, int W, int Cin,
                                        int Cout, int pool,
                                        cudaStream_t stream) {
  if (Cin == 3 && Cout == 32 && !pool)
    return launch<3, 32>(in, w, bias, out, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch_mma<32, 32, true, true>(in, w, bias, wsplit, out, route,
                                          mask, keep, N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch_mma<32, 64, false, true>(in, w, bias, wsplit, out, nullptr,
                                           nullptr, 1.f, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch_mma<64, 64, true, true>(in, w, bias, wsplit, out, route,
                                          mask, keep, N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

// H19: gx (N, H, W, Cin) from the layer's output gradient gy (the shape of
// its output) and, for a pooled layer, route and mask (or null), for an
// unpooled one its output y; layers 2-4 of BraaiD6 only (the triplets need
// no gradient). wsplit is scratch of 18 Cin Cout floats, 16-byte aligned
// (the weights split hi/lo).
extern "C" int zuds_braai_conv3x3_dgrad(const float* gy,
                                        const uint8_t* route,
                                        const uint8_t* mask, const float* y,
                                        float keep, const float* w,
                                        float* wsplit, float* gx, int N,
                                        int H, int W, int Cin, int Cout,
                                        int pool, cudaStream_t stream) {
  if (Cin == 32 && Cout == 32 && pool)
    return launch_dgrad<32, 32, true>(gy, route, mask, y, keep, w, wsplit, gx,
                                      N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch_dgrad<32, 64, false>(gy, route, mask, y, keep, w, wsplit,
                                       gx, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch_dgrad<64, 64, true>(gy, route, mask, y, keep, w, wsplit, gx,
                                      N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

// H20: out (9 Cin Cout + Cout) f32, the HWIO weight gradient then the bias
// gradient, from the layer's input x (N, H, W, Cin) and what H19 takes;
// partial is scratch of N (9 Cin Cout + Cout) floats (a chunk's partial
// each; a chunk holds 1-4 images).
extern "C" int zuds_braai_conv3x3_wgrad(const float* x, const float* gy,
                                        const uint8_t* route,
                                        const uint8_t* mask, const float* y,
                                        float keep, float* partial,
                                        float* out, int N, int H, int W,
                                        int Cin, int Cout, int pool,
                                        cudaStream_t stream) {
  if (Cin == 3 && Cout == 32 && !pool)
    return launch_wgrad<3, 32, false>(x, gy, route, mask, y, keep, partial,
                                      out, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch_wgrad<32, 32, true>(x, gy, route, mask, y, keep, partial,
                                      out, N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch_wgrad<32, 64, false>(x, gy, route, mask, y, keep, partial,
                                       out, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch_wgrad<64, 64, true>(x, gy, route, mask, y, keep, partial,
                                      out, N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

namespace {

template <typename K>
int resources(K* kernel, int threads, size_t smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
    return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)cudaSuccess;
}

template <int CIN, int COUT, bool POOL>
int backward_resources(int kind, int W, int* out) {
  if constexpr (CIN % 32 == 0) {
    if (kind == 0)
      return resources(dgrad_kernel<CIN, COUT, POOL>, kDgThreads,
                       dgrad_smem<CIN>(W), out);
  } else if (kind == 0) {
    return (int)cudaErrorInvalidValue;     // the triplets: no H19
  }
  const int We = POOL ? 2 * ((W - 2) / 2) : W - 2;
  return resources(wgrad_kernel<CIN, COUT, POOL>, kWgThreads,
                   wgrad_smem<CIN, COUT, POOL>(W, We), out);
}

}  // namespace

// What H19 (kind 0; layers 2-4) or H20 (kind 1) takes at a layer whose
// input is W wide: out[0] registers a thread, out[1] local (spilled) bytes
// a thread, out[2] dynamic shared memory a block, out[3] blocks resident
// on one SM.
extern "C" int zuds_braai_backward_resources(int kind, int Cin, int Cout,
                                             int pool, int W, int* out) {
  if (W < 3) return (int)cudaErrorInvalidValue;
  if (Cin == 3 && Cout == 32 && !pool)
    return backward_resources<3, 32, false>(kind, W, out);
  if (Cin == 32 && Cout == 32 && pool)
    return backward_resources<32, 32, true>(kind, W, out);
  if (Cin == 32 && Cout == 64 && !pool)
    return backward_resources<32, 64, false>(kind, W, out);
  if (Cin == 64 && Cout == 64 && pool)
    return backward_resources<64, 64, true>(kind, W, out);
  return (int)cudaErrorInvalidValue;
}
