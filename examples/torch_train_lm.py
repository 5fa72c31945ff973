"""End-to-end LM training on the port, with a crash and a resume: the
reference's ``examples/train_lm.py`` with its imports taken from
``repro_torch`` and a ``--device`` option (the card by default;
``--device cpu`` trains through the attention kernel's plain versions).
It trains a reduced stablelm-family model for half the steps,
checkpointing, "crashes", resumes from the last checkpoint for the rest,
and checks that the loss fell across the restart.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \
        [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import argparse  # noqa: E402
import tempfile  # noqa: E402


def main(argv=None):
    from repro_torch.launch import train as train_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--smoke", "--batch", "8", "--seq", "64",
              "--ckpt-every", "25", "--device", args.device]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        # phase 1: train half the steps, checkpointing
        out1 = train_mod.main(common + ["--steps", str(args.steps // 2),
                                        "--ckpt-dir", ckpt_dir])
        # phase 2: 'crash' and resume from the checkpoint
        print("\n[example] simulating restart — resuming from checkpoint")
        out2 = train_mod.main(common + [
            "--steps", str(args.steps - args.steps // 2),
            "--ckpt-dir", ckpt_dir])
    first, last = out1["losses"][0], out2["losses"][-1]
    print(f"\n[example] loss {first:.3f} → {last:.3f} across restart")
    assert last < first, "training did not learn"
    return out1, out2


if __name__ == "__main__":
    main()
