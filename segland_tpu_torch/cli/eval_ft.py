"""Fine-tuned model evaluation entry point (reference eval_ft.py).  Port of
segland_tpu/cli/eval_ft.py: eval_base with ``--is-ft`` appended, which gives
the per-seed loop, square-longside logits against ignore-padded labels
(eval_ft.py:168-178), the saturated novel colormap and no .mat export.

    python -m segland_tpu_torch.cli.eval_ft --data-dir DATA --val-list LIST \\
        --model swin_pop --restore-from best.pth --dtype bfloat16 --eval-batch 8
"""

import sys

from .eval_base import get_parser, main as _main  # noqa: F401  (get_parser re-exported)


def main(argv=None):
    args_list = list(sys.argv[1:] if argv is None else argv)
    if "--is-ft" not in args_list:
        args_list.append("--is-ft")
    return _main(args_list)


if __name__ == "__main__":
    main()
