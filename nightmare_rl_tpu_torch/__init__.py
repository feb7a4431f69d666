"""PyTorch/CUDA port of nightmare_rl_tpu: batched MuJoCo-semantics physics,
the nightmare_v3 hexapod task and PPO, with the PGS contact solve as a CUDA
kernel written for Hopper (``ops/csrc/pgs.cu``).

The package imports torch, numpy and the standard library only.  Entry
points run on the card unless the caller asks for ``device="cpu"``.
"""
