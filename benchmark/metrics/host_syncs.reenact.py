"""Host syncs a frame: the program's ``sync.*`` spans (each a read of the
device's data, or a copy to it, that waits for the device) in the
profiled stretch, over its units. None where the program opens no
``G.*`` span of its own there."""


def syncs_a_unit(rec):
    names = [n for cat, n, _, _ in rec.host if cat == 'user_annotation']
    if not rec.prof_units or not any(n.startswith('G.') for n in names):
        return None
    return sum(n.startswith('sync.') for n in names) / rec.prof_units


read = syncs_a_unit
