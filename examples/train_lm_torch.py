"""End-to-end training driver on the PyTorch port: a stablelm-family model
trained on the synthetic pipeline, with checkpointing and restart.  The
twin of ``examples/train_lm.py``: the same ``--steps``/``--tiny`` flags
and the same arguments to ``repro_torch.launch.train``, on the card
unless ``--device cpu`` is given; the checkpoints go under the temporary
directory (``TMPDIR``), not a fixed ``/tmp`` path.

Full run (~100M params):
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
Quick check:
    PYTHONPATH=src python examples/train_lm_torch.py --steps 40 --tiny \\
        --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tiny:
        argv = ["--arch", "stablelm-1.6b", "--reduced",
                "--steps", str(args.steps), "--batch", "8", "--seq", "64",
                "--lr", "3e-3", "--ckpt-dir",
                os.path.join(tempfile.gettempdir(),
                             "repro_torch_train_lm_tiny")]
    else:
        # ~100M: stablelm wiring at 12 layers × 768
        argv = ["--arch", "stablelm-1.6b", "--layers", "12",
                "--d-model", "768", "--steps", str(args.steps),
                "--batch", "8", "--seq", "256", "--lr", "1e-3",
                "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                           "repro_torch_train_lm_100m")]
    train_launcher.main(argv + ["--device", args.device])


if __name__ == "__main__":
    main()
