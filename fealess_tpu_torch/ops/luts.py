"""The response lookup table the port reads (its own copy of
``fealess_tpu.ops.luts``, the part it uses).

``ORIENTATION_SCORES[d]`` is the response of a feature whose orientation
bin lies at circular distance ``d`` (0..4) from the scene's nearest spread
bin: the active table of the reference (linemod/linemod.cpp:968-970; the
two commented alternatives there are [4,1,0,0,0] and [4,3,2,1,0]).
``ops/response.py`` computes the responses from it by bit arithmetic.
"""

ORIENTATION_SCORES = (4, 2, 1, 0, 0)
