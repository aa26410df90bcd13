"""Device stages of indexed decode: the K1 token decode + stamp
(:mod:`.inflate_stamp`), the indexed inflate around it
(:mod:`.inflate_checkpoint`), the K3 defilter (:mod:`.unfilter`) and the
pixel convolve (:mod:`.convolve`)."""
