"""The whole AutoInt step's share of the card's peak: ``step_mfu.train``'s
own reading (the model module's least time a step over the window's wall
time a step, in %), for the AutoInt cell, which that reader does not list.
The operations bound it (the attention stack's). Moves
``train_examples_per_s``."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("step_mfu.train.py")))[
    "read"]
