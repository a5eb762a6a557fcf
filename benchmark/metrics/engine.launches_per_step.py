"""Device kernels launched in the traced window over the decode steps in
it (the fills of the window's admissions included)."""


def read(record):
    t, w = record.trace, record.work
    if t is None or not w.get('decode_steps'):
        return None
    return t.launches() / w['decode_steps']
