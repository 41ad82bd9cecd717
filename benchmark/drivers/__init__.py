"""One driver per kind of entry a cell's window drives (``traffic.entry``)."""
