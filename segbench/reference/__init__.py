"""Plain PyTorch references of what the cells run: LinkNet34 and
FC-DenseNet67, the tiled D4/pyramid inference, the two losses and the two
optimizers. They import nothing of segtpu_torch, segtpu or JAX, and take
nothing that the program made: the benchmark hands them the same seeded
weights and inputs that it hands the program.

Each computes in fp32 with TF32 off (:class:`numerics.Numerics`), or, as
the correctness check's control, with every convolution's input and weight
rounded to fp8 (e4m3, scaled per tensor): the precision below the bf16 that
the configurations state.
"""
