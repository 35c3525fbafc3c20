"""The CFD application: the MAC-grid Navier-Stokes solver and its cases."""
