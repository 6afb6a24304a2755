"""Device operations: variant apply, translation, edit distances (exact,
banded, Myers, local, all-pairs), the banded traceback, and the forward
step."""
