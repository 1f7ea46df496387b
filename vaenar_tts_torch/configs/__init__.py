"""Hyper-parameter trees and their JSON form."""
