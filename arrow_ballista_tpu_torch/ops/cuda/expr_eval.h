// Launch interface of expr_eval.cu, shared with its PyTorch binding and
// mirrored by ops/kernels.py (EXPR_OPS, DT_*, EXPR_MAX_*).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kExprMaxInputs = 96;    // env tensors one program reads
constexpr int kExprMaxOutputs = 72;   // outputs it writes (pred, pvalid, 2 x 32 columns)
constexpr int kExprMaxInstr = 1024;   // rows of code, stores included
constexpr int kExprSmemLimit = 232448;  // shared memory a CTA can use on sm_90

// Register dtypes: the port's device dtypes, x64's and x32's.  An int32
// register holds its value sign-extended, a float32 one its bits in the
// low word.
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

struct ExprEvalParams {
  const ExprInstr* code;     // [n_instr] (device)
  const long long* consts;   // IN tables (device), just after the code
  long long n;               // rows
  int n_instr;
  int n_regs;
  const void* in[kExprMaxInputs];   // env tensors; null: absent validity
  void* out[kExprMaxOutputs];       // outputs; null: not written
};

// Registers whose validity bits fit one 64-bit word a thread; past it the
// validities are bytes in shared memory.
constexpr int kExprMaskRegs = 64;

// Shared memory of one CTA of `threads` threads: the code, then each
// register's 8-byte values (and 1-byte validities past kExprMaskRegs)
// for every thread.
inline size_t expr_smem_bytes(int n_instr, int n_regs, int threads) {
  const size_t per_reg = n_regs <= kExprMaskRegs ? 8 : 9;
  return (size_t)n_instr * sizeof(ExprInstr) + (size_t)n_regs * threads * per_reg;
}

extern "C" cudaError_t expr_eval_launch(const ExprEvalParams* p, cudaStream_t stream);
