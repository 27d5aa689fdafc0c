"""Serve an assigned architecture on the PyTorch port with batched
requests: prefill + greedy decode through the KV/state-cache path, as
``examples/serve_arch.py`` does on the JAX package (the reduced config;
``--full`` serves the full-width config on the card).

  PYTHONPATH=src python examples/serve_arch_torch.py
  PYTHONPATH=src python examples/serve_arch_torch.py --arch deepseek-moe-16b \\
      --device cpu

It runs on the CUDA card unless ``--device`` names another torch device:
every attention layer of the prefill goes through the hand-written
flash-attention kernel there (jamba's reduced config has one, at layer
4; its Mamba layers are plain PyTorch, as in the reference).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import build_parser, main as serve_main

if __name__ == "__main__":
    # the driver's parser with the reference example's defaults
    parser = build_parser()
    parser.set_defaults(arch="jamba-1.5-large-398b", batch=2, prompt_len=12,
                        tokens=8)
    serve_main(sys.argv[1:], parser=parser)
