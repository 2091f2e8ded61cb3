"""Merge several submission pickles into one.

Counterpart of `diffusiondrive_tpu/script/run_merge_submission_pickles.py`
(navsim's `run_merge_submission_pickles.py`). Reads pickles of either
package (`cli_common.load_submission`) and writes the port's classes. It
computes nothing, so it takes no device.
"""

from __future__ import annotations

import argparse
import logging
import pickle
from typing import Optional, Sequence

from diffusiondrive_torch.script.cli_common import load_submission


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("inputs", nargs="+", help="submission pickles to merge")
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    merged = None
    predictions = {}
    for path in args.inputs:
        sub = load_submission(path)
        if merged is None:
            merged = {k: v for k, v in sub.items() if k != "predictions"}
        for pred in sub["predictions"]:
            predictions.update(pred)
    merged["predictions"] = [predictions]
    with open(args.output, "wb") as fp:
        pickle.dump(merged, fp)
    logging.info("Merged %d pickles -> %d predictions at %s", len(args.inputs), len(predictions), args.output)


if __name__ == "__main__":
    main()
