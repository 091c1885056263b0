"""STPR pose refinement (port of ``ucnerf_tpu/pose``): features and
matching in torch, COLMAP interop and the pipeline in numpy, the rig bundle
adjuster in host C++ (``csrc/rigba.cc``)."""
