"""Batched serving example on the PyTorch port: a reduced qwen2-family
model fills its KV cache from a prompt batch by repeated decode, then
decodes greedily.  The twin of ``examples/serve_lm.py``: the same
launcher arguments through ``repro_torch.launch.serve``, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    serve.main(["--arch", "qwen2-7b", "--batch", "4", "--prompt-len", "16",
                "--tokens", "24", "--device", device])


if __name__ == "__main__":
    main()
