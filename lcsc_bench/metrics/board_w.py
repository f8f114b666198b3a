"""board_w: the board's mean power.draw over the window (nvidia-smi,
every 100 ms), in W."""


def read(rec):
    return rec["watts"]
