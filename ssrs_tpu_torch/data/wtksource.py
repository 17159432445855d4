"""Copy of ``ssrs_tpu/data/wtksource.py``, unchanged apart from imports.

WindToolKit data-source registry.

Reference semantics (ssrs/wtk/wtksource.py): map a source name to HDF5
file paths, valid years, and an h5py-like access module; probe the first
file for the layer list. Additions over the reference:

- an explicit ``LOCAL:<path-template>`` source so the full WTK pipeline is
  testable offline against h5py fixture files,
- h5pyd is optional: the AWS/HSDS source raises a clear error when the
  module or the ``.hscfg`` API key is missing instead of failing at import.
"""

from __future__ import annotations

import importlib
import os
from typing import List


class WtkSource:
    """WTK source descriptor (ssrs/wtk/wtksource.py:7-60)."""

    valid_sources = ('AWS', 'EAGLE', 'EAGLE_LED', 'LOCAL')

    def __init__(self, sname: str, local_template: str = '',
                 local_years: List[int] = None):
        self.api_website = None
        if sname == 'AWS':
            self.years = list(range(2007, 2015))
            fname = '/nrel/wtk/conus/wtk_conus_$YEAR.h5'
            self.module_name = 'h5pyd'
            self.api_website = 'https://developer.nrel.gov/signup/'
        elif sname == 'EAGLE':
            self.years = list(range(2007, 2015))
            fname = '/datasets/WIND/conus/v1.0.0/wtk_conus_$YEAR.h5'
            self.module_name = 'h5py'
        elif sname == 'EAGLE_LED':
            self.years = list(range(2018, 2020))
            fname = ('/lustre/eaglefs/shared-projects/wtk-led/ERA5_En1/'
                     'wtk_ERA5_En1_$YEAR.h5')
            self.module_name = 'h5py'
        elif sname == 'LOCAL':
            if not local_template:
                raise ValueError(
                    'LOCAL WTK source needs local_template (a path with '
                    '$YEAR) and local_years')
            self.years = list(local_years or [])
            fname = local_template
            self.module_name = 'h5py'
        else:
            raise ValueError(
                f'Unknown WindToolKit source {sname!r}; pick one of '
                + ', '.join(self.valid_sources))

        self.source_name = sname
        self.file_names = [fname.replace('$YEAR', str(yr))
                           for yr in self.years]
        try:
            self.hsds = importlib.import_module(self.module_name)
        except ImportError as exc:
            raise ImportError(
                f'WTK source {sname} needs the {self.module_name} module, '
                f'which is not installed in this environment.') from exc
        try:
            with self.hsds.File(self.file_names[0], mode='r') as f_obj:
                self.valid_layers = list(f_obj)
        except FileNotFoundError:
            if sname in ('EAGLE', 'EAGLE_LED'):
                hint = (f'the {sname} paths only exist on NREL HPC '
                        'filesystems; use the AWS/HSDS source elsewhere')
            else:
                hint = ('the HSDS endpoint did not respond; check '
                        'connectivity and retry')
            raise FileNotFoundError(
                f'WTK: could not open {self.file_names[0]} ({hint})'
            ) from None
        except OSError:
            if sname != 'AWS':
                raise
            # h5pyd raises a bare OSError when no .hscfg credentials
            # resolve; re-probe to surface the reference's API-key
            # guidance (ssrs/wtk/wtksource.py:52-60) instead of the raw
            # error (validate_aws_source raises ValueError).
            self.validate_aws_source()
            raise
        if sname == 'AWS':
            self.validate_aws_source()

    def validate_aws_source(self):
        """Probe the HSDS connection (needs a valid .hscfg,
        ssrs/wtk/wtksource.py:52-60)."""
        hscfg_fpath = os.path.join(os.getcwd(), '.hscfg')
        try:
            with self.hsds.File(self.file_names[0], mode='r') as f_obj:
                _ = list(f_obj)
        except OSError:
            raise ValueError(
                'WTK: the HSDS probe failed — the .hscfg credentials file '
                f'at {hscfg_fpath} is missing or holds an invalid API key '
                '(get one at https://developer.nrel.gov/signup/)'
            ) from None


def create_hscfg_file(api_key: str, fpath: str) -> None:
    """Write an .hscfg HSDS credentials file for the NREL developer API
    (format per ssrs/wtk/wtksource.py:63-70)."""
    settings = {
        'hs_endpoint': 'https://developer.nrel.gov/api/hsds',
        'hs_username': 'None',
        'hs_password': 'None',
        'hs_api_key': api_key,
    }
    with open(fpath, 'w', encoding='utf-8') as f_obj:
        f_obj.write(''.join(f'{k} = {v}\n' for k, v in settings.items()))
