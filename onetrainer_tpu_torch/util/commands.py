"""Inbound command mailbox polled by the trainer between steps
(reference: modules/util/commands/TrainCommands.py)."""

from collections.abc import Callable


class TrainCommands:
    def __init__(self):
        self.__stop_command = False
        self.__sample_custom_commands: list = []
        self.__sample_default_command = False
        self.__backup_command = False
        self.__save_command = False

    def stop(self):
        self.__stop_command = True

    def get_stop_command(self) -> bool:
        return self.__stop_command

    def sample_custom(self, sample_config):
        self.__sample_custom_commands.append(sample_config)

    def get_and_reset_sample_custom_commands(self) -> list:
        commands = self.__sample_custom_commands
        self.__sample_custom_commands = []
        return commands

    def sample_default(self):
        self.__sample_default_command = True

    def get_and_reset_sample_default_command(self) -> bool:
        command = self.__sample_default_command
        self.__sample_default_command = False
        return command

    def backup(self):
        self.__backup_command = True

    def get_and_reset_backup_command(self) -> bool:
        command = self.__backup_command
        self.__backup_command = False
        return command

    def save(self):
        self.__save_command = True

    def get_and_reset_save_command(self) -> bool:
        command = self.__save_command
        self.__save_command = False
        return command
