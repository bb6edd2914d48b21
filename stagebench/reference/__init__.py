"""The plain reference the benchmark holds the program to.

Plain PyTorch (f32, TF32 off) and NumPy.  It imports neither JAX, nor
the JAX package, nor the program: it takes the benchmark's weights
(`stagebench.weights`) and batches, never anything the program made.

- `params`: a configuration's sizes and parameter layout;
- `model`: the dense and hybrid language models' loss, in blocks;
- `train`: the first steps of training and the readings compared;
- `precision`: f32 products, and the fp8 ones of the control;
- `frontier`: the monitor's window shares and routing.
"""
