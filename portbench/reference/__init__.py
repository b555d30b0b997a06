"""Plain PyTorch references of the benchmark's configurations, f32 with
TF32 off. They import nothing of the program; they take the weights and
inputs the benchmark made from the seed, and the program's outputs only to
judge them."""
