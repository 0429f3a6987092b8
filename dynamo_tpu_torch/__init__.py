"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu.

The package mirrors ``dynamo_tpu``'s module paths so that each module's
counterpart is easy to find. It imports torch, numpy and the standard
library only: never jax, and nothing from ``dynamo_tpu`` (it keeps its
own copies of what it needs). Every kernel the JAX package wrote in
Pallas is a hand-written CUDA kernel here (``ops/csrc``); the plain
PyTorch version beside each kernel serves CPU tensors and the tests.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), as the tests do.
"""
