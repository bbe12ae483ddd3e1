// T1: the elementwise-throughput probe, by dtype and op mix.
//
// Replaces tools/vpu16.py `build` (pl.pallas_call at :60), which measures
// how fast the TPU's vector unit issues the wavefront's op mix (add,
// compare, select, max) per dtype, to learn whether narrowing the score
// planes from int32 buys anything.  Here the question is which
// instructions the card issues per dtype and at what rate, and the
// answer for a narrow dtype depends on its packed forms.
//
// What bounds it on the H100: operations.  A few bytes per element
// against tens of thousands of operations; the rate is set by the
// instructions a round issues and the pipe each one issues on.  So the
// narrow dtypes run packed, as many elements per thread as a 32-bit
// register holds, each op one instruction over all of them where the
// card has one:
// - bfloat16: two per thread, .bf16x2 add / sub / max and set.gt into a
//   per-half mask, the select a lop3 on that mask;
// - int8: four per thread; the card has no 8-bit SIMD add (vadd4 is a
//   PRMT sequence), so the add is the 32-bit add of the low seven bits of
//   each lane with the lanes' sign bits put back by xor (((a & 0x7f..) +
//   (b & 0x7f..)) ^ ((a ^ b) & 0x80..)): four instructions for four
//   lanes, where the unpacked form spent two (an add and a sign
//   extension) per lane.  A round is a chain of three of them and the
//   shape's 147,456 elements make only 36,864 threads, so the case runs
//   at the chain's latency, not the pipes' rate;
// - int16: one per thread, unpacked (add.s16, setp.gt.s16, selp.b16,
//   sub.s16): the card has .s16x2 min/max but no .s16x2 add, sub or
//   compare, and neither vadd2 / vsub2 / vset2 (PRMT sequences in the
//   SASS) nor a masked 32-bit add nor two halves a thread beat it
//   (tools/torch_vpu16_forms.py);
// - int32 and float32: one element per thread, as before.
// tools/vpu16.py's LANES and PEAK_PER_SM_CLOCK hold each case's lanes per
// register and the peak of the instruction it issues.
//
// One element slot per thread holds the accumulator in a register,
// initialised to x; `rounds` rounds of the mix with b = x, where rounds
// = steps x iters of the TPU kernel's grid steps and unrolled iterations
// (a kernel argument, in unrolled groups of UNROLL).
//
// One instruction per counted op and slot.  Left to the compiler, the
// rounds fold: ptxas, which sees through an empty asm statement, issued
// one IADD3 per two int32 adds (a + b + b) and the int32 mix as four
// instructions per six ops (IADD3 for a - 1 and the next add, VIMNMX,
// ISETP and a predicated subtract in place of the select), over the
// card's per-instruction peak.  So the rounds are PTX in one asm block,
// each op (each round, for int8's four instructions of one add) guarded
// by one of two predicates, p and q, alternating: both are true at run
// time, but they come from kernel arguments, so no two neighbouring ops
// can be merged into one instruction.  DPX (__viaddmax_*), which fuses an
// add and a max, is left out for that reason.
//
// Semantics of the TPU kernel, kept exactly: every op wraps in the dtype
// (PTX .s32 and .s16 arithmetic; int8's lanes by the masked add),
// bfloat16 rounds after every op (.rn.bf16x2 arithmetic, sm_90), float32
// rounds to nearest (.rn; the values stay integers below 2^24).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 64;          // rounds per pass of the PTX loop

enum Mix { MIX_ADD = 0, MIX_MIX = 1, MIX_MIX16 = 2 };
enum Dtype { DT_INT32 = 0, DT_INT16 = 1, DT_FLOAT32 = 2, DT_BF16 = 3,
             DT_INT8 = 4 };

#define X2(s) s s
#define X4(s) X2(X2(s))
#define X16(s) X4(X4(s))
#define X32(s) X2(X16(s))
#define X64(s) X4(X16(s))

// The loop: %0 the accumulator a, %1 b, %2 / %3 the two predicates' flags
// (1 and 1), %4 the rounds (a positive multiple of UNROLL).  b is copied
// to a register of the block's own first (the compiler may hand a and b,
// equal on entry, to the asm in one register).  BODY is UNROLL rounds on
// %0 and B; DECL and INIT declare and set its scratch, FINI writes it
// back to %0.
#define VPU16_LOOP(TYPE, DECL, INIT, BODY, FINI)                           \
    "{\n\t"                                                                \
    ".reg .pred p, q, g, more;\n\t"                                        \
    ".reg .b32 n;\n\t"                                                     \
    ".reg " TYPE " B;\n\t" DECL                                            \
    "mov" TYPE " B, %1;\n\t"                                               \
    "setp.ne.s32 p, %2, 0;\n\t"                                            \
    "setp.ne.s32 q, %3, 0;\n\t"                                            \
    "mov.b32 n, %4;\n\t" INIT                                              \
    "VPU16_LOOP:\n\t" BODY                                                 \
    "sub.s32 n, n, 64;\n\t"                                                \
    "setp.gt.s32 more, n, 0;\n\t"                                          \
    "@more bra VPU16_LOOP;\n\t" FINI                                       \
    "}"

// one round of each mix (tools/vpu16.py:42-55); the mixes have 1 or 6
// ops, so `add` alternates p, q over two rounds
#define ADD2(T) "@p add" T " %0, %0, B;\n\t@q add" T " %0, %0, B;\n\t"
#define MIX(ADD, MAX, GT, SUB, SEL, ONE)                                   \
    "@p " ADD " %0, %0, B;\n\t"          /* 1: a + b */                  \
    "@q " MAX " %0, %0, B;\n\t"          /* 2: max(a, b) */              \
    "@p " GT " g, %0, B;\n\t"            /* 3: a > b */                  \
    "@q " SUB " d, %0, B;\n\t"           /* 4: a - b */                  \
    "@p " SEL " %0, d, %0, g;\n\t"       /* 5: where */                  \
    "@q " SUB " %0, %0, " ONE ";\n\t"    /* 6: a - 1 */
// bf16x2: the compare writes a per-half mask m (0xffff where a > b), the
// select is lop3 (m ? d : a, table 0xe4)
#define MIX_BF16X2                                                         \
    "@p add.rn.bf16x2 %0, %0, B;\n\t"    /* 1 */                         \
    "@q max.bf16x2 %0, %0, B;\n\t"       /* 2 */                         \
    "@p set.gt.u32.bf16x2 m, %0, B;\n\t" /* 3 */                         \
    "@q sub.rn.bf16x2 d, %0, B;\n\t"     /* 4 */                         \
    "@p lop3.b32 %0, d, %0, m, 0xe4;\n\t" /* 5 */                        \
    "@q sub.rn.bf16x2 %0, %0, one;\n\t"  /* 6 */
#define MIX16                                                              \
    "@p add.s16 %0, %0, B;\n\t"          /* 1: a + b */                  \
    "@q setp.gt.s16 g, %0, B;\n\t"       /* 2, 3: where(a > b, a, b) */  \
    "@p selp.b16 %0, %0, B, g;\n\t"                                        \
    "@q setp.gt.s16 g, %0, B;\n\t"       /* 4, 5, 6: where(a > b, */     \
    "@p sub.s16 d, %0, B;\n\t"           /*          a - b, a) */        \
    "@q selp.b16 %0, d, %0, g;\n\t"
// int8x4: a + b in each byte lane, wrapping: the low seven bits' sum
// (L = b & 0x7f7f7f7f, set once), its lane sign bits put back by xor with
// the lanes' (a ^ b) & 0x80808080 (one lop3, table 0x28)
#define ADD8X4(P)                                                          \
    "@" P " and.b32 t, %0, 0x7f7f7f7f;\n\t"                               \
    "@" P " add.s32 t, t, L;\n\t"                                          \
    "@" P " lop3.b32 u, %0, B, 0x80808080, 0x28;\n\t"                     \
    "@" P " xor.b32 %0, t, u;\n\t"

template <int DT, int MX> struct Rounds;

#define ROUNDS(DT, MX, REG, CON, TYPE, DECL, INIT, BODY, FINI)             \
    template <> struct Rounds<DT, MX> {                                    \
        using Reg = REG;                                                   \
        __device__ static void run(Reg& a, Reg b, int on0, int on1,       \
                                   int rounds) {                           \
            asm volatile(VPU16_LOOP(TYPE, DECL, INIT, BODY, FINI)          \
                         : "+" CON(a)                                      \
                         : CON(b), "r"(on0), "r"(on1), "r"(rounds));       \
        }                                                                  \
    };

ROUNDS(DT_INT32, MIX_ADD, int32_t, "r", ".b32", "", "", X32(ADD2(".s32")),
       "")
ROUNDS(DT_INT32, MIX_MIX, int32_t, "r", ".b32", ".reg .b32 d;\n\t", "",
       X64(MIX("add.s32", "max.s32", "setp.gt.s32", "sub.s32", "selp.b32",
               "1")), "")
ROUNDS(DT_INT16, MIX_ADD, int16_t, "h", ".b16", "", "", X32(ADD2(".s16")),
       "")
ROUNDS(DT_INT16, MIX_MIX16, int16_t, "h", ".b16", ".reg .b16 d;\n\t", "",
       X64(MIX16), "")
ROUNDS(DT_FLOAT32, MIX_ADD, float, "f", ".f32", "", "",
       X32(ADD2(".rn.f32")), "")
ROUNDS(DT_FLOAT32, MIX_MIX, float, "f", ".f32", ".reg .f32 d;\n\t", "",
       X64(MIX("add.rn.f32", "max.f32", "setp.gt.f32", "sub.rn.f32",
               "selp.f32", "0f3F800000")), "")
ROUNDS(DT_BF16, MIX_ADD, uint32_t, "r", ".b32", "", "",
       X32(ADD2(".rn.bf16x2")), "")
ROUNDS(DT_BF16, MIX_MIX, uint32_t, "r", ".b32",
       ".reg .b32 d, m, one;\n\t", "mov.b32 one, 0x3f803f80;\n\t",
       X64(MIX_BF16X2), "")
ROUNDS(DT_INT8, MIX_ADD, uint32_t, "r", ".b32", ".reg .b32 t, u, L;\n\t",
       "and.b32 L, B, 0x7f7f7f7f;\n\t", X32(ADD8X4("p") ADD8X4("q")), "")

// elements per thread (lanes of the 32-bit register; tools/vpu16.py LANES)
template <int DT> struct Lanes { static constexpr int n = 1; };
template <> struct Lanes<DT_BF16> { static constexpr int n = 2; };
template <> struct Lanes<DT_INT8> { static constexpr int n = 4; };

// one register per thread: `slots` of them, each Lanes<DT>::n elements of
// x in memory order
template <int DT, int MX>
__global__ void __launch_bounds__(THREADS)
vpu16_kernel(const typename Rounds<DT, MX>::Reg* __restrict__ x,
             typename Rounds<DT, MX>::Reg* __restrict__ out, int slots,
             int rounds, int on0, int on1) {
    int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= slots) return;
    using R = Rounds<DT, MX>;
    typename R::Reg b = x[i];
    typename R::Reg a = b;
    if (rounds > 0) R::run(a, b, on0, on1, rounds);
    out[i] = a;
}

template <int DT, int MX>
int launch(const void* x, void* out, int n, int rounds, cudaStream_t s) {
    using Reg = typename Rounds<DT, MX>::Reg;
    if (n % Lanes<DT>::n) return (int)cudaErrorInvalidValue;
    const int slots = n / Lanes<DT>::n;
    int blocks = (slots + THREADS - 1) / THREADS;
    if (blocks == 0) return 0;
    vpu16_kernel<DT, MX><<<blocks, THREADS, 0, s>>>(
        static_cast<const Reg*>(x), static_cast<Reg*>(out), slots, rounds,
        1, 1);
    return (int)cudaGetLastError();
}

}  // namespace

// The nine cases of tools/vpu16.py main (:75-84).  rounds must be a
// multiple of UNROLL and n of the case's lanes; another (dtype, mix)
// returns cudaErrorInvalidValue.
extern "C" int vpu16_launch(int dtype, int mix, const void* x, void* out,
                            int n, int rounds, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rounds < 0 || rounds % UNROLL != 0 || n < 0)
        return (int)cudaErrorInvalidValue;
    switch (dtype * 3 + mix) {
    case DT_INT32 * 3 + MIX_ADD:
        return launch<DT_INT32, MIX_ADD>(x, out, n, rounds, s);
    case DT_INT32 * 3 + MIX_MIX:
        return launch<DT_INT32, MIX_MIX>(x, out, n, rounds, s);
    case DT_INT16 * 3 + MIX_ADD:
        return launch<DT_INT16, MIX_ADD>(x, out, n, rounds, s);
    case DT_INT16 * 3 + MIX_MIX16:
        return launch<DT_INT16, MIX_MIX16>(x, out, n, rounds, s);
    case DT_FLOAT32 * 3 + MIX_ADD:
        return launch<DT_FLOAT32, MIX_ADD>(x, out, n, rounds, s);
    case DT_FLOAT32 * 3 + MIX_MIX:
        return launch<DT_FLOAT32, MIX_MIX>(x, out, n, rounds, s);
    case DT_BF16 * 3 + MIX_ADD:
        return launch<DT_BF16, MIX_ADD>(x, out, n, rounds, s);
    case DT_BF16 * 3 + MIX_MIX:
        return launch<DT_BF16, MIX_MIX>(x, out, n, rounds, s);
    case DT_INT8 * 3 + MIX_ADD:
        return launch<DT_INT8, MIX_ADD>(x, out, n, rounds, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
