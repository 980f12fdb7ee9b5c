"""The plain reference of the grasp detector: preprocessing, the PointNet++
grasp models (PN2_CLS, PN2) in eval mode, post-processing and the
collision check, written from the S4G detector's published semantics in
plain PyTorch.  It imports nothing of the program and takes nothing the
program made: weights and clouds come from the benchmark, random draws are
replayed from the seeds the benchmark gave the program.

Every function takes a `Precision`: the configuration's own (bf16 matmul
operands in the backbone and heads, f32 everywhere else) for the check,
or one step below it (fp8 operands, bf16 values) for the control.
"""
