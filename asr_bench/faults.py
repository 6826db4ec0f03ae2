"""Faults planted under the timed path, to see the check fail: the
harness's tests plant them at a small size on the CPU, and
``asr_bench/calibrate.py --fault`` reads them on the card at a cell's own
size. Each takes the object the cell's driver hands it: the
``ASRInference`` of a transcription cell.
"""


def altered_token(asr):
    """Every transcript's first character replaced, by another letter of
    the vocabulary, where the text is made."""
    greedy = asr.greedy
    decode_batch = greedy.decode_batch

    def altered(*args, **kwargs):
        return [("e" + t[1:]) if t[:1] != "e" else ("k" + t[1:])
                for t in decode_batch(*args, **kwargs)]

    greedy.decode_batch = altered


FAULTS = {"altered_token": altered_token}
