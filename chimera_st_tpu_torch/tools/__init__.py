"""Command-line tools around training (counterpart of chimera_st_tpu/tools/)."""
