"""The worker processes: the lockstep runtime of a multi-process world."""
