"""Logging + CLI helpers shared by every driver.

``Logger`` tees stdout/stderr to a file exactly like the reference
(CVC-YOLOv3/utils/utils.py:8-22, RektNet/utils.py:25-39: ``.log`` files tee
stdout, ``.error`` files tee stderr).

``add_bool_arg`` reproduces the reference's ``--x/--no_x`` mutually
exclusive flag pattern repeated in every CLI (train.py:264-268 etc.).
"""

from __future__ import annotations

import os
import sys


class Logger(object):
    def __init__(self, File: str):
        Type = File.split(".")[-1]
        if Type == "error":
            self.terminal = sys.stderr
        else:
            self.terminal = sys.stdout
        os.makedirs(os.path.dirname(File) or ".", exist_ok=True)
        # line-buffered: training runs spend long stretches inside
        # compiles — a block-buffered tee keeps the log empty exactly
        # when an operator tails it to see progress
        self.log = open(File, "w", buffering=1)

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def add_bool_arg(parser, name: str, default: bool, help: str):
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--" + name, dest=name, action="store_true", help=help)
    group.add_argument("--no_" + name, dest=name, action="store_false",
                       help="Do not " + help)
    parser.set_defaults(**{name: default})


def write_score_file(path: str, value: float):
    """The cross-process metric channel used by the sweep layer
    (train.py:236-240, train_eval.py:182-186)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(str(value))
