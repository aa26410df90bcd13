"""Device stages of indexed decode: the K1 token decode + stamp
(:mod:`.inflate_stamp`), the indexed inflate around it
(:mod:`.inflate_checkpoint`) with the K2 records copy for match-dominated
batches (:mod:`.inflate_seqcopy`), the K3 defilter (:mod:`.unfilter`) and the
pixel convolve (:mod:`.convolve`); of general decode: the fused inflate as
torch ops (:mod:`.inflate_fused`) and the Adam7 deinterlace
(:mod:`.deinterlace`); and of level 8–13 encode: filter select
(:mod:`.filter`), the K4 candidate search and K5 parse with the pipeline
around them (:mod:`.deflate_optimal`), K6 term emission
(:mod:`.deflate_emit`) and the packers, the block writer and the greedy
match search of the shared-trees encode (:mod:`.deflate`)."""
