"""End-to-end LM training driver example on the PyTorch port, as
``examples/train_lm.py`` runs it on the JAX package: train the reduced
Qwen3 variant for a few hundred steps on the synthetic token pipeline,
then write a checkpoint.

  PYTHONPATH=src python examples/train_lm_torch.py
  PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu

Arguments go to ``repro_torch.launch.train`` as given (it runs on the
CUDA card unless ``--device`` names another torch device: flash attention
and its backward kernel there). With none, the reference example's:
qwen3-4b reduced, 200 steps, batch 8, sequence 128, lr 3e-3, and a
checkpoint under ``build/train_lm_torch_ckpt`` (the port writes under
``build/``).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "qwen3-4b", "--steps", "200", "--batch", "8", "--seq",
            "128", "--lr", "3e-3", "--ckpt", "build/train_lm_torch_ckpt"]

if __name__ == "__main__":
    train_main(sys.argv[1:] or DEFAULTS)
