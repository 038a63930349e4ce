"""synthesize_s: per-proof mean seconds of the program's ``synthesize`` mark
(the witness: the WNN circuit's gadgets filled for the image). Layer:
frontend."""


def read(run):
    return run.mark("synthesize")
