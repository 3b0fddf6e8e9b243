"""The benchmark's plain reference, float32 with TF32 off: the noise
(`noise/`, frozen plain copies of the port's noise modules), the
detector (`detector.py`) and the detections (`postprocess.py`).  It
imports nothing of the program; `arith.Arith('control')` computes the
same one step below the precision each stage states."""
