"""CRI containers: @UTF tables, AFS2 (AWB) banks, ACB cue databases, CPK
archives, USM movies and their IVF video (readers, build_afs2, build_ivf,
UTFBuilder, AWBBuilder, ACBBuilder, CPKBuilder, USMBuilder)."""
