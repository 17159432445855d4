"""US Wind Turbine Database (USWTDB) client.

``ssrs_tpu/data/turbines.py`` on the port's column table
(``data/table.py``) instead of a pandas DataFrame: fetch the USWTDB REST
JSON, reproject turbine locations into the run CRS, filter to bounds and
minimum hub height, expose per-project queries and a formatted summary.
On any connection failure ``dframe`` is None. ``requests`` is imported
where the fetch happens, so the module loads without it. The
``turbines.csv`` it saves reads back in either package."""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from .crs import transform_coordinates
from .table import Table


def records_to_table(records) -> Table:
    """A JSON list of records (one object a row) as a table: columns in
    order of first appearance; a column of whole numbers int64 (also when
    the JSON writes them as ``80.0``, as ``pandas.read_json`` has it), other
    numbers and numbers with a null float64, anything else strings."""
    if not isinstance(records, list) or \
            not all(isinstance(r, dict) for r in records):
        raise ValueError('expected a JSON list of objects')
    names = list(dict.fromkeys(k for r in records for k in r))
    cols = {}
    for name in names:
        vals = [r.get(name) for r in records]
        if all(isinstance(v, int) and not isinstance(v, bool)
               for v in vals):
            cols[name] = np.array(vals, dtype=np.int64)
        elif all(v is None or (isinstance(v, (int, float))
                               and not isinstance(v, bool)) for v in vals):
            col = np.array([np.nan if v is None else v for v in vals],
                           dtype=np.float64)
            whole = np.isfinite(col).all() and (np.abs(col) < 2. ** 53).all() \
                and (col == np.round(col)).all()
            cols[name] = col.astype(np.int64) if whole else col
        else:
            col = np.empty(len(vals), dtype=object)
            col[:] = [np.nan if v is None else v for v in vals]
            cols[name] = col
    return Table(cols)


class TurbinesUSWTB:
    """USWTDB turbine data (ssrs/turbines.py:10-121)."""

    url = ('https://eersc.usgs.gov/api/uswtdb/v1/turbines?&t_cap=gt.0&'
           'select=t_state,p_name,p_year,t_cap,t_hh,t_rd,xlong,ylat')
    lonlat_crs = 'EPSG:4326'

    def __init__(self, bounds: Tuple[float, float, float, float],
                 crs_string: str = 'EPSG:4326',
                 min_hubheight: float = 50.,
                 out_fpath: Optional[str] = 'turbines.csv',
                 print_verbose: bool = False,
                 dataframe=None):
        """``dataframe`` injects raw USWTDB-shaped data (a ``Table`` or a
        dict of columns; offline fixtures); otherwise the REST endpoint is
        queried."""
        print('TurbinesUSWTB: Importing turbine data from USWTB..')
        if dataframe is not None:
            dfraw = Table.from_any(dataframe)
        else:
            try:
                import requests
                resp = requests.get(self.url, timeout=(4, 120))
                resp.raise_for_status()
                dfraw = records_to_table(json.loads(resp.content))
            except Exception:
                print('Connection issues with USWTB database!')
                self.dframe = None
                return

        if crs_string.lower() != 'epsg:4326':
            self._xcol, self._ycol = 'x', 'y'
            xlocs, ylocs = transform_coordinates(
                self.lonlat_crs, crs_string, dfraw['xlong'], dfraw['ylat'])
            dfraw = dfraw.assign(x=xlocs, y=ylocs)
        else:
            self._xcol, self._ycol = 'xlong', 'ylat'

        xvals, yvals, hh = dfraw[self._xcol], dfraw[self._ycol], dfraw['t_hh']
        xbool = (xvals >= bounds[0]) & (xvals <= bounds[2])
        ybool = (yvals >= bounds[1]) & (yvals <= bounds[3])
        hhbool = (hh >= min_hubheight) & (hh < 10000.)
        self.dframe = dfraw.select(xbool & ybool & hhbool)
        if out_fpath is not None:
            try:
                self.dframe.to_csv(out_fpath)
            except OSError as exc:
                print(f'TurbinesUSWTB: could not save {out_fpath}: {exc}')
        if print_verbose:
            self.print_details()

    def get_locations(self):
        return self.dframe[self._xcol], self.dframe[self._ycol]

    def get_locations_for_this_project(self, pname: str):
        sel = self.dframe['p_name'] == pname
        return self.dframe[self._xcol][sel], self.dframe[self._ycol][sel]

    def get_project_names(self):
        """Project names in order of first appearance."""
        return np.array(list(dict.fromkeys(self.dframe['p_name'])),
                        dtype=object)

    def print_details(self):
        """Formatted summary (ssrs/turbines.py:97-121)."""
        if self.dframe is None or len(self.dframe) == 0:
            print('TurbinesUSWTB: No wind turbines found within the '
                  'bounds!')
            return
        df = self.dframe
        print(f'Number of projects: {len(self.get_project_names())}')
        print(f'Number of turbines: {len(df)}')
        print(f'Hub height (min,median,max): {df["t_hh"].min()}, '
              f'{np.median(df["t_hh"])}, {df["t_hh"].max()}')
        print(f'Rotor Dia (min,median,max): {df["t_rd"].min()}, '
              f'{np.median(df["t_rd"])}, {df["t_rd"].max()}')
        print(f'    {"Project":<26}{"State":<6}{"Year":<6}'
              f'{"Count":<6}{"Hub_Hght":<10}{"Rotor_Dia":<10}')
        by_rotor = df.sort_values('t_rd', ascending=False)['p_name']
        for i, wfname in enumerate(dict.fromkeys(by_rotor)):
            sel = df.select(df['p_name'] == wfname)
            print(f'{str(i + 1) + ".":<4}{wfname[:24]:<26}'
                  f'{sel["t_state"][0]:<6}'
                  f'{int(sel["p_year"][0]):<6}'
                  f'{len(sel):<6}'
                  f'{np.median(sel["t_hh"]):<10}'
                  f'{np.median(sel["t_rd"]):<10}')
