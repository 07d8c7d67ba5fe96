// Launch interface of expr_eval.cu, shared with its PyTorch binding and
// mirrored by ops/kernels.py (EXPR_OPS, DT_*, EXPR_MAX_*, EXPR_REG_*,
// expr_launch_plan).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

constexpr int kExprMaxInputs = 96;    // env tensors one program reads
constexpr int kExprMaxOutputs = 72;   // outputs it writes (pred, pvalid, 2 x 32 columns)
constexpr int kExprMaxInstr = 1024;   // rows of code, stores included
constexpr int kExprSmemLimit = 232448;  // shared memory a CTA can use on sm_90

// Register dtypes: the port's device dtypes, x64's and x32's.
enum ExprDtype : int { kDtBool = 0, kDtI64 = 1, kDtF64 = 2, kDtI32 = 3, kDtF32 = 4 };

// Opcodes, in the order of ops/kernels.py:EXPR_OPS.
enum ExprOp : int {
  kOpLeaf, kOpLit, kOpNull, kOpConvert, kOpCastI64, kOpAnd, kOpOr, kOpNot,
  kOpEq, kOpNe, kOpLt, kOpLe, kOpGt, kOpGe, kOpAdd, kOpSub, kOpMul,
  kOpDivInt, kOpDivF, kOpModInt, kOpModF, kOpNeg, kOpIsNull, kOpIsNotNull,
  kOpIn, kOpNotIn, kOpSelect, kOpAbs, kOpSqrt, kOpExp, kOpLn, kOpLog10, kOpLog2,
  kOpCeil, kOpFloor, kOpSin, kOpCos, kOpTan, kOpSignum, kOpRound, kOpPower,
  kOpSquare, kOpStoreValue, kOpStoreValid, kOpSqPairLo,
};

// One row of code (32 bytes).  Row i < n_regs computes register i from
// registers a, b, c; a leaf reads input slots a (value, -1: none) and b
// (validity, null pointer: all valid); an IN list compares against
// consts[b, b + c); a literal's value is imm; a store writes register a
// to output slot b in dtype out_dt.
struct ExprInstr {
  int op;      // the opcode in bits 0-7, the dtypes of registers a, b, c in
               // bits 8-15, 16-23, 24-31
  int out_dt;  // result dtype
  int in_dt;   // operand dtype (comparisons, arithmetic, IN, convert)
  int a;
  int b;
  int c;
  long long imm;
};

// Where a register lives, one int32 a register (ops/kernels.py:
// ExprProgram.reg_layout, made once a program): bits 0-1 the kind, bit 2
// set when its value is the same on every row (computed once a CTA), bit
// 3 set for an 8-byte tile register, bits 4+ the index in its kind's
// storage.
enum ExprRegKind : int {
  kRegTile = 0,     // a block of R values a thread (expr_block_bytes);
                    // index: its place among the tiles of its width
  kRegUniform = 1,  // one 8-byte value for the CTA; index: its slot
  kRegLeaf = 2,     // an input column's staged tile; index: the input slot
  kRegMask = 3,     // a bool: one bit a row, a byte a thread; index: its slot
};
constexpr int kRegInvariant = 4;
constexpr int kRegWide = 8;

constexpr int kExprMaxRows = 8;      // rows a thread in one tile (a mask byte)
constexpr int kExprMaxThreads = 256;
constexpr int kExprPlanSms = 132;    // the H100's SMs, for the small-batch rule
constexpr size_t kExprSmemPerSm = 233472;  // shared memory of one SM (228 KB)
constexpr size_t kExprSmemPerCta = 1024;   // what the runtime keeps a CTA
constexpr int kExprRegsPerSm = 65536;
constexpr int kExprMaxRegs = 128;          // a thread's registers (the kernel's launch bounds)

struct ExprEvalParams {
  const ExprInstr* code;     // [n_instr] (device)
  const long long* consts;   // IN tables (device), just after the code
  const int* layout;         // [n_regs] ExprRegKind words (device)
  long long n;               // rows
  int n_instr;
  int n_regs;
  int n_uniform;             // kRegUniform slots
  int n_mask;                // kRegMask slots
  int n_wide;                // 8-byte tile registers
  int n_narrow;              // 4-byte tile registers
  int n_scratch;             // 8-byte blocks a thread for converted operands
  int staged_w[3];           // staged slots of 1, 4 and 8 bytes
  int rows;                  // R: rows a thread a tile (set at launch)
  int stages;                // staging buffers (2: the next tile's copy in
                             // flight while this one runs; set at launch)
  int stage_bytes;           // one staging buffer (set at launch)
  int n_staged;
  const void* in[kExprMaxInputs];   // env tensors; null: absent (an absent
                                    // validity is all valid)
  void* out[kExprMaxOutputs];       // outputs; null: not written
  // per row of code (bit i of word i / 32): a register's validity may be
  // present in this batch (else every row is valid), and the row has
  // nothing to do a tile (an invariant register, a numeric leaf with no
  // validity, a store to an output not written)
  unsigned valid_bits[kExprMaxInstr / 32];
  unsigned skip_bits[kExprMaxInstr / 32];
  int stage_off[kExprMaxInputs];    // a slot's byte offset in a staging buffer
                                    // (set at launch); -1: not staged
  unsigned char width[kExprMaxInputs];   // a staged slot's element bytes
  unsigned char staged[kExprMaxInputs];  // the staged slots, n_staged of them
};

__host__ __device__ inline size_t expr_align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline size_t expr_align128(size_t x) { return (x + 127) & ~(size_t)127; }

// A thread's block of `rows` values of `width` bytes: its rows are
// consecutive, read and written 16 bytes at a time, and the 16-byte
// chunks of a block of 32 or 64 bytes are swizzled by thread
// (expr_eval.cu:swizzle) so that the 8 threads of a 16-byte access phase
// fall in distinct banks.
__host__ __device__ inline int expr_block_bytes(int rows, int width) { return rows * width; }

// Shared memory of one CTA of `threads` threads, `rows` rows each: the
// layout words, the uniform values, two 8-byte slots a thread for an
// invariant operand converted, a validity byte a register and a thread, a
// value byte a bool register and a thread, then (128-byte aligned) the
// scratch and tile blocks and `stages` staging buffers of the leaf
// columns (`staged_w`: how many of 1, 4 and 8 bytes).
inline size_t expr_smem_bytes(int n_regs, int n_uniform, int n_mask, int n_wide, int n_narrow,
                              int n_scratch, const int* staged_w, int threads, int rows,
                              int stages) {
  const size_t t = threads;
  const size_t b8 = expr_block_bytes(rows, 8), b4 = expr_block_bytes(rows, 4);
  const size_t stage =
      t * (staged_w[0] * (size_t)expr_block_bytes(rows, 1) + staged_w[1] * b4 + staged_w[2] * b8);
  return expr_align128(expr_align16(4 * (size_t)n_regs) + expr_align16(8 * (size_t)n_uniform) +
                       16 * t + expr_align16(t * n_regs) + expr_align16(t * n_mask)) +
         t * ((size_t)(n_scratch + n_wide) * b8 + (size_t)n_narrow * b4) +
         (size_t)stages * expr_align128(stage);
}

struct ExprPlan {
  int threads;  // T
  int rows;     // R
  int stages;
  size_t smem;
};

// Warps an SM holds of CTAs of `threads` threads taking `smem` bytes
// each (shared memory, and registers at kExprMaxRegs a thread).
inline int expr_resident_warps(int threads, size_t smem) {
  const size_t by_smem = kExprSmemPerSm / (smem + kExprSmemPerCta);
  const size_t by_regs = (size_t)kExprRegsPerSm / ((size_t)kExprMaxRegs * threads);
  const size_t ctas = by_smem < by_regs ? by_smem : by_regs;
  return (int)(ctas * threads / 32);
}

// The tile rule.  R, the rows a thread, is the largest of 8, 4, 2, 1 at
// which some shape holds 8 warps an SM (R = 1: any shape that fits);
// among R's shapes (128, 64, 256 or 32 threads; two staging buffers or
// one), the one an SM holds the most warps of, ties to two buffers, then
// to the order of the threads listed.  A batch of fewer tiles than two an
// SM halves R, then (below one an SM) the threads down to 64.  smem past
// kExprSmemLimit: the program does not fit.
inline ExprPlan expr_plan(long long n, int n_regs, int n_uniform, int n_mask, int n_wide,
                          int n_narrow, int n_scratch, const int* staged_w) {
  static const int kThreads[4] = {128, 64, 256, 32};
  auto bytes = [&](const ExprPlan& c) {
    return expr_smem_bytes(n_regs, n_uniform, n_mask, n_wide, n_narrow, n_scratch, staged_w,
                           c.threads, c.rows, c.stages);
  };
  ExprPlan pl{kThreads[3], 1, 1, 0};
  int warps = -1;
  for (int rows = kExprMaxRows; rows >= 1 && warps < 8; rows /= 2) {
    warps = -1;
    for (int stages = 2; stages >= 1; --stages) {
      for (int j = 0; j < 4; ++j) {
        const ExprPlan c{kThreads[j], rows, stages, 0};
        const size_t smem = bytes(c);
        if (smem > (size_t)kExprSmemLimit) continue;
        const int w = expr_resident_warps(c.threads, smem);
        if (w > warps) {
          warps = w;
          pl = c;
        }
      }
    }
  }
  auto tiles = [&]() {
    const long long tr = (long long)pl.threads * pl.rows;
    return (n + tr - 1) / tr;
  };
  while (pl.rows > 1 && tiles() < 2 * kExprPlanSms) pl.rows /= 2;
  while (pl.threads > 64 && tiles() < kExprPlanSms) pl.threads /= 2;
  pl.smem = bytes(pl);
  return pl;
}

extern "C" cudaError_t expr_eval_launch(const ExprEvalParams* p, cudaStream_t stream);

// What a launch over `n` rows of a program of these sizes (`counts`: the
// uniform, mask, 8- and 4-byte tile registers and scratch blocks;
// `staged_w`: the staged slots of 1, 4 and 8 bytes) runs with: out =
// {threads, rows a thread, staging buffers, shared bytes (expr_plan), the
// kernel's registers a thread, its local bytes a thread, CTAs an SM at
// that shape (0 when the shape does not fit)}.
extern "C" cudaError_t expr_eval_describe(long long n, int n_regs, const int* counts,
                                          const int* staged_w, long long* out);
