"""Export a trained checkpoint as a serving artifact that reloads without the
model's code:

    python -m segtpu_torch.export_model --model saved/PSPNet/<ts>/best_model \\
        --output exported/pspnet --batch 1 --hw 1025,2049 [--device cpu]

Counterpart of ``scripts/export_model.py``. Writes ``model.pt2``
(``torch.export``, weights inside, for ``--device``, ``cuda`` by default) and
``serving.json``. Serve with torch alone:

    from segtpu_torch.serving import load_serving_artifact
    call, meta = load_serving_artifact("exported/pspnet")
    preds, conf = call(uint8_batch)
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="segtpu_torch serving export")
    p.add_argument("-m", "--model", required=True,
                   help="checkpoint directory with meta.json")
    p.add_argument("-o", "--output", required=True, help="output directory")
    p.add_argument("-b", "--batch", type=int, default=1)
    p.add_argument("--hw", default="513,513",
                   help="input H,W the program is exported for")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the device the program runs on (default cuda)")
    args = p.parse_args(argv)

    from segtpu_torch.serving import export_checkpoint

    hw = tuple(int(v) for v in args.hw.split(","))
    out = export_checkpoint(args.model, args.output, batch=args.batch, hw=hw,
                            device=args.device)
    print(f"exported to {out}")
    return out


if __name__ == "__main__":
    main()
