"""Cost and roofline tools: ``op_cost`` counts what one eager call does,
``roofline`` turns the counts into the H100's least time."""
