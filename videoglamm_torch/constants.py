"""Token constants shared by the splicer and the pipeline (the values of
videoglamm_tpu/constants.py that the port reads)."""

IMAGE_TOKEN_INDEX = -200     # placeholder id marking where visual tokens splice in
