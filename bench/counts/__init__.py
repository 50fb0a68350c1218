"""The frozen counts: useful FLOPs and bytes of each cell's work, and the
card's data-sheet rates they are held against."""
