"""Operations and bytes of the port's kernels, counted from the model's shapes
(never measured from a kernel), one module per kernel named as its trace
events are, and the card's published peaks. Frozen here so that a parent and
a change are held to the same count."""
