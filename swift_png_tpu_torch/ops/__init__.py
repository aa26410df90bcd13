"""Device stages of indexed decode: the K1 token decode + stamp
(:mod:`.inflate_stamp`), the indexed inflate around it
(:mod:`.inflate_checkpoint`) with the K2 records copy for match-dominated
batches (:mod:`.inflate_seqcopy`), the K3 defilter (:mod:`.unfilter`) and the
pixel convolve (:mod:`.convolve`)."""
