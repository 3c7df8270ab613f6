"""Candidate field registry of the outgoing alert schemas (twin of
``zuds_tpu/alert_fields.py``).

Field names and avro types carry the reference's broker contract
(``zuds/alert_schemas/schema_single/candidate.avsc``, 123 fields, and
``schema_stack/candidate.avsc``, 124), grouped by provenance: pipeline
measurements, image metadata, reference-stack provenance, detection
history, and the PS1 / LegacySurvey-DR8 / name-service crossmatch blocks
(3 nearest neighbours each, ``crossmatch.py``). Brokers key on these
exact names.
"""
from __future__ import annotations

__all__ = ['CANDIDATE_FIELDS_SINGLE', 'CANDIDATE_FIELDS_STACK',
           'candidate_fields', 'candidate_defaults']

D, F, I, L, S = 'double', 'float', 'int', 'long', 'string'


def _n(t):
    """Nullable union."""
    return [t, 'null']


# measurement + metadata fields common to the single and stack schemas
_COMMON = [
    ('candid', L), ('pid', L), ('programid', I), ('programpi', S),
    ('pdiffimfilename', S), ('alert_type', S), ('isdiffpos', S),
    ('field', I), ('rcid', I), ('fid', I),
    ('ra', F), ('dec', F), ('xpos', F), ('ypos', F),
    ('aimage', F), ('bimage', F), ('elong', F), ('fwhm', F),
    ('aimagerat', F), ('bimagerat', F), ('snr', F), ('exptime', F),
    ('drb', F), ('drbversion', S),
    # name services (comma-joined match lists; '' when none/offline)
    ('ztfname', S), ('mqid', S), ('tnsid', S),
    # reference-stack provenance
    ('jdstartref', D), ('jdendref', D), ('nframesref', I),
    # detection history (single-epoch and stack streams)
    ('ndethist_single', I), ('ndethist_stack', I),
    ('jdstarthist_single', _n(D)), ('jdendhist_single', _n(D)),
    ('jdstarthist_stack', _n(D)), ('jdendhist_stack', _n(D)),
]

_SINGLE_ONLY = [('jd', D), ('nid', I), ('diffmaglim', F)]
_STACK_ONLY = [('jdstartstack', D), ('jdendstack', D), ('jdmed', D),
               ('nframesstack', I)]

# PS1 DR1 + star/galaxy score, 3 nearest (zuds/crossmatch.py:85-186)
_PS1 = [(f'{base}{i}', t)
        for i in (1, 2, 3)
        for base, t in [('objectidps', _n(L)), ('sgscore', _n(F)),
                        ('distpsnr', _n(F)), ('psgmag', _n(F)),
                        ('psrmag', _n(F)), ('psimag', _n(F)),
                        ('pszmag', _n(F))]]

# LegacySurvey DR8, 3 nearest (zuds/crossmatch.py:189-241)
_LS = [(f'{base}{i}', t)
       for i in (1, 2, 3)
       for base, t in [('lsobjectid', _n(L)), ('lsdistnr', _n(F)),
                       ('lstype', _n(S)), ('lsebv', _n(F)),
                       ('lsg', _n(F)), ('lsr', _n(F)), ('lsz', _n(F)),
                       ('lsw1_', _n(F)), ('lsw2_', _n(F)), ('lsw3_', _n(F)),
                       ('lsw4_', _n(F)),
                       ('lsgaiag', _n(F)), ('lsgaiap', _n(F)),
                       ('lszphotmean', _n(F)), ('lszphotmed', _n(F)),
                       ('lszphotstd', _n(F)), ('lszphotl68', _n(F)),
                       ('lszphotu68', _n(F)), ('lszphotl95', _n(F)),
                       ('lszphotu95', _n(F)), ('lszspec', _n(F))]]

CANDIDATE_FIELDS_SINGLE = _COMMON + _SINGLE_ONLY + _PS1 + _LS   # 123
CANDIDATE_FIELDS_STACK = _COMMON + _STACK_ONLY + _PS1 + _LS     # 124

assert len(CANDIDATE_FIELDS_SINGLE) == 123
assert len(CANDIDATE_FIELDS_STACK) == 124


def candidate_fields(alert_type='single'):
    return (CANDIDATE_FIELDS_STACK if alert_type == 'stack'
            else CANDIDATE_FIELDS_SINGLE)


def candidate_defaults(alert_type='single'):
    """Schema-valid default for every field (used for keys the pipeline
    could not populate: 0/''/None by nullability)."""
    out = {}
    for name, typ in candidate_fields(alert_type):
        if isinstance(typ, list):
            out[name] = None
        elif typ == S:
            out[name] = ''
        elif typ in (I, L):
            out[name] = 0
        else:
            out[name] = 0.0
    return out
