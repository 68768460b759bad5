"""Pad values of the vocal-to-accompaniment conditions (port of
``versband_tpu/data/vocal2accomp.py:36-37``).

The datasets of that module (``JoinSpecsTrain``, ``JoinSpecsValidation``,
``JoinSpecsTest``) are not ported yet (ROADMAP Queue 1 item 8); the inference
CLI needs only these constants.
"""

MIDI_PAD = 128  # pitch value of a frame with no MIDI note
BEATS_PAD = 2  # beat value of a frame with no beat annotation
