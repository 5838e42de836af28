"""Host ms a train step the trainer waited for its prefetched batches
(`Trainer.train` in `pending.result()`), over every K-step call of the
run that waited for one: the untraced window's and the traced window's
(the first call of each `train()` places its batch itself and waits for
none). Read from the program's counters
(`dvdgan_tpu_torch.utils.profiling.COUNTERS`); None where the program
keeps none."""

LAYER = "trainer loop and data"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_clips_per_s"
BETTER = "lower"


def read(r):
    from dvdgan_tpu_torch.utils import profiling
    c = getattr(profiling, "COUNTERS", None)
    steps = getattr(c, "loader_wait_steps", 0)
    return c.loader_wait_s * 1e3 / steps if steps else None
