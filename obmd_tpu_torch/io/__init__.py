"""Input and output of the port: the LAMMPS deck front end (`script`)
and its expressions (`expr`), data files (`lammps_data`), molecule
templates (`molecule`), trajectory dumps (`dump`, `dump_dcd`),
checkpoints (`checkpoint`) and the C++ reader and writers (`native`)."""
